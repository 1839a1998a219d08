"""Carry parameters and train states from the JAX package into the port.

``from_jax_params(cfg, tree, device=...)`` takes the tree ``repro``'s model builds
(``jax.tree_util.tree_map(np.asarray, model.init(key))``: nested dicts of
numpy arrays, per-layer leaves stacked on a leading ``(L, ...)`` axis) and
loads it into the port's ``DecoderLM``, layer by layer: the dense leaves,
the four MoE leaves (``router``, and ``wi`` / ``wg`` / ``wo`` in JAX's
layout: plain ``(E, d, f)`` or, for fewer than 16 experts, the virtual
``(V, d, f/parts)``, which the port un-virtualises only at use) and the
twelve SSM leaves of a mamba2 layer (``A_log, D, conv_b, conv_w, dt_bias,
gate_norm, in_B, in_C, in_dt, in_x, in_z, out``).  Both packages keep
weights as ``(d_in, d_out)`` and compute ``x @ W``, so nothing is
transposed.

``from_jax_train_state`` carries a whole JAX ``TrainState`` with numpy
leaves (params, AdamW step / mu / nu, error feedback).  ``named_from_tree``
maps JAX's stacked layout to the port's parameter names (``embed.tokens``,
``layers.3.ssm.in_x``, ...).

The other way, ``to_jax_named`` writes a port ``TrainState`` in the names
``repro``'s checkpointer gives a JAX ``TrainState`` (``0/layers/ssm/in_x``
stacked on ``(L, ...)``, ``1/.step``, ``1/.mu/...``, ``1/.nu/...``, ``2/...``
for the error feedback), in JAX's flatten order, and ``load_jax_named``
copies such arrays back into a port ``TrainState`` in place.  This module
does not import JAX.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import DecoderLM, build_model
from repro_torch.train.optimizer import AdamWState
from repro_torch.train.train_step import TrainState


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def from_jax_params(cfg: ModelConfig, tree, *, device,
                    trainable: bool = False) -> DecoderLM:
    return build_model(cfg, _to_torch(tree), device=device,
                       trainable=trainable)


def named_from_tree(tree, num_layers: int) -> Dict[str, np.ndarray]:
    """A JAX-layout tree as {port parameter name: leaf}, the stacked
    per-layer leaves split into ``layers.<i>.<group>.<leaf>``."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif path and path[0] == "layers":
                for i in range(num_layers):
                    out[".".join(("layers", str(i)) + path[1:] + (k,))] = v[i]
            else:
                out[".".join(path + (k,))] = v

    walk(tree, ())
    return out


def from_jax_train_state(cfg: ModelConfig, state, *, device):
    """A port ``TrainState`` from a JAX ``TrainState`` whose leaves are
    numpy arrays (``jax.tree_util.tree_map(np.asarray, state)``)."""
    model = from_jax_params(cfg, state.params, device=device, trainable=True)

    def tensors(tree):
        return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
                for k, v in named_from_tree(tree, cfg.num_layers).items()}

    opt = AdamWState(int(np.asarray(state.opt.step)), tensors(state.opt.mu),
                     tensors(state.opt.nu))
    err = tensors(state.err) if state.err is not None else None
    return TrainState(model, opt, err)


def jax_layout(names, num_layers: int) -> List[Tuple[str, List[str], bool]]:
    """JAX's leaves of a parameter tree, in its flatten order (dict keys
    sorted at every level): ``[(path, port names, stacked), ...]``, where
    ``path`` is ``embed/tokens`` or ``layers/ssm/in_x`` and a stacked leaf
    lists its ``num_layers`` port names in layer order."""
    leaves: Dict[Tuple[str, ...], List[str]] = {}
    stacked = set()
    for name in names:
        m = re.fullmatch(r"layers\.(\d+)\.(.+)", name)
        if m:
            key = ("layers",) + tuple(m.group(2).split("."))
            leaves.setdefault(key, [None] * num_layers)[int(m.group(1))] = name
            stacked.add(key)
        else:
            leaves[tuple(name.split("."))] = [name]
    return [("/".join(k), leaves[k], k in stacked) for k in sorted(leaves)]


def _host_leaf(tree, names: List[str], stacked: bool) -> np.ndarray:
    """One JAX leaf on the host, copied layer by layer into one array
    allocated up front (the host holds one copy, and training may go on
    updating the tensors in place once this returns)."""
    first = tree[names[0]]
    shape = ((len(names),) if stacked else ()) + tuple(first.shape)
    host = torch.empty(shape, dtype=first.dtype)
    with torch.no_grad():
        if stacked:
            for i, n in enumerate(names):
                host[i].copy_(tree[n])
        else:
            host.copy_(first)
    return host.numpy()


def to_jax_named(state: TrainState) -> Dict[str, np.ndarray]:
    """A port ``TrainState`` as ``{name: host array}`` in the names and
    the order ``repro.utils.tree.flatten_with_names`` gives a JAX
    ``TrainState`` of the same model: params under ``0/``, the AdamW step
    (0-d int32) and moments under ``1/``, the error feedback under ``2/``
    (absent without compression)."""
    params = state.params
    layout = jax_layout(params, state.model.cfg.num_layers)
    out: Dict[str, np.ndarray] = {}

    def put(prefix, tree):
        for path, names, stacked in layout:
            out[prefix + path] = _host_leaf(tree, names, stacked)

    put("0/", params)
    out["1/.step"] = np.asarray(state.opt.step, np.int32)
    put("1/.mu/", state.opt.mu)
    put("1/.nu/", state.opt.nu)
    if state.err is not None:
        put("2/", state.err)
    return out


@torch.no_grad()
def load_jax_named(template: TrainState, arrays: Mapping) -> TrainState:
    """Copy arrays named as ``to_jax_named`` names them (a JAX checkpoint's
    ``np.load``) into ``template``'s tensors in place, leaf by leaf, and
    return a ``TrainState`` over them: the device never holds a second
    state.  The error feedback is read only when ``template`` has one."""
    params = template.params
    layout = jax_layout(params, template.model.cfg.num_layers)

    def fill(prefix, tree):
        for path, names, stacked in layout:
            a = np.asarray(arrays[prefix + path])
            want = ((len(names),) if stacked else ()) \
                + tuple(tree[names[0]].shape)
            if a.shape != want:
                raise ValueError(f"{prefix + path}: shape {a.shape}, the "
                                 f"model needs {want}")
            for i, n in enumerate(names):
                tree[n].copy_(torch.from_numpy(
                    np.ascontiguousarray(a[i] if stacked else a)))

    fill("0/", params)
    fill("1/.mu/", template.opt.mu)
    fill("1/.nu/", template.opt.nu)
    if template.err is not None:
        fill("2/", template.err)
    opt = AdamWState(int(np.asarray(arrays["1/.step"])), template.opt.mu,
                     template.opt.nu)
    return TrainState(template.model, opt, template.err)
