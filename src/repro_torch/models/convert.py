"""Carry parameters and train states from the JAX package into the port.

``from_jax_params(cfg, tree, device=...)`` takes the tree ``repro``'s model builds
(``jax.tree_util.tree_map(np.asarray, model.init(key))``: nested dicts of
numpy arrays, per-layer leaves stacked on a leading ``(L, ...)`` axis) and
loads it into the port's ``DecoderLM`` (or ``EncDecLM``), layer by layer:
the dense leaves, the four MoE leaves (``router``, and ``wi`` / ``wg`` /
``wo`` in JAX's layout: plain ``(E, d, f)`` or, for fewer than 16
experts, the virtual ``(V, d, f/parts)``, which the port un-virtualises
only at use), the
twelve SSM leaves of a mamba2 layer (``A_log, D, conv_b, conv_w, dt_bias,
gate_norm, in_B, in_C, in_dt, in_x, in_z, out``), a hybrid layer's
attention, MLP, SSM and two mixing norms, the prefix's top-level
leaves: the bare ``meta_tokens`` (hybrid) and the ``patch_proj`` group
(vlm), and whisper's (encdec) second stacked group, the ``encoder``, beside
the decoder's ``layers`` with their cross-attention, layernorms and gelu
MLPs.  Both packages keep weights as ``(d_in, d_out)`` and compute
``x @ W``, so nothing is transposed.

``from_jax_train_state`` carries a whole JAX ``TrainState`` with numpy
leaves (params, AdamW step / mu / nu, error feedback).  ``named_from_tree``
maps JAX's stacked layout to the port's parameter names (``embed.tokens``,
``layers.3.ssm.in_x``, ``encoder.3.attn.wq``, ...).

The other way, ``to_jax_named`` writes a port ``TrainState`` in the names
``repro``'s checkpointer gives a JAX ``TrainState`` (``0/layers/ssm/in_x``
stacked on ``(L, ...)``, ``0/encoder/attn/wq`` on ``(encoder_layers, ...)``,
``1/.step``, ``1/.mu/...``, ``1/.nu/...``, ``2/...``
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
from repro_torch.models.lm import build_model, shard_params
from repro_torch.train.optimizer import AdamWState
from repro_torch.train.train_step import TrainState


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def from_jax_params(cfg: ModelConfig, tree, *, device,
                    trainable: bool = False, plan=None):
    """The port's model of ``cfg`` holding ``repro``'s parameter tree
    ``tree``; with ``plan`` (a storage plan, ``train_step.param_plan``)
    as this rank's shards of it, cut leaf by leaf."""
    params = _to_torch(tree) if plan is None else shard_params(tree, plan)
    return build_model(cfg, params, device=device, trainable=trainable,
                       plan=plan)


def _stacked_counts(num_layers: int, encoder_layers: int) -> Dict[str, int]:
    """The stacked groups of a tree and each one's layer count.  Each
    count comes from its own config field: whisper's encoder and decoder
    both have 32 layers (2 reduced), so a test cannot tell them apart."""
    return {"layers": num_layers, "encoder": encoder_layers}


def named_from_tree(tree, num_layers: int,
                    encoder_layers: int = 0) -> Dict[str, np.ndarray]:
    """A JAX-layout tree as {port parameter name: leaf}, the stacked
    per-layer leaves split into ``layers.<i>.<group>.<leaf>`` (and an
    encdec tree's ``encoder.<i>.<group>.<leaf>``); a top-level bare leaf
    keeps its own name (``meta_tokens``)."""
    counts = _stacked_counts(num_layers, encoder_layers)
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif path and path[0] in counts:
                for i in range(counts[path[0]]):
                    out[".".join((path[0], str(i)) + path[1:] + (k,))] = v[i]
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
                for k, v in named_from_tree(tree, cfg.num_layers,
                                            cfg.encoder_layers).items()}

    opt = AdamWState(int(np.asarray(state.opt.step)), tensors(state.opt.mu),
                     tensors(state.opt.nu))
    err = tensors(state.err) if state.err is not None else None
    return TrainState(model, opt, err)


def jax_layout(names, num_layers: int, encoder_layers: int = 0
               ) -> List[Tuple[str, List[str], bool]]:
    """JAX's leaves of a parameter tree, in its flatten order (dict keys
    sorted at every level): ``[(path, port names, stacked), ...]``, where
    ``path`` is ``embed/tokens``, ``layers/ssm/in_x`` or
    ``encoder/attn/wq`` and a stacked leaf lists its group's port names
    (``num_layers`` or ``encoder_layers`` of them) in layer order."""
    counts = _stacked_counts(num_layers, encoder_layers)
    leaves: Dict[Tuple[str, ...], List[str]] = {}
    stacked = set()
    for name in names:
        m = re.fullmatch(r"(layers|encoder)\.(\d+)\.(.+)", name)
        if m:
            group = m.group(1)
            key = (group,) + tuple(m.group(3).split("."))
            leaves.setdefault(key, [None] * counts[group])[
                int(m.group(2))] = name
            stacked.add(key)
        else:
            leaves[tuple(name.split("."))] = [name]
    return [("/".join(k), leaves[k], k in stacked) for k in sorted(leaves)]


def _host_leaf(leaf, names: List[str], stacked: bool, keep: bool = True):
    """One JAX leaf on the host, copied layer by layer (``leaf(name)`` is
    each layer's tensor) into one array allocated up front (the host holds
    one copy, and training may go on updating the tensors in place once
    this returns).  Without ``keep`` each layer's tensor is made and
    dropped (a rank taking part in another rank's gathers) and None is
    returned."""
    host = None
    with torch.no_grad():
        for i, n in enumerate(names):
            t = leaf(n)
            if not keep:
                continue
            if host is None:
                shape = ((len(names),) if stacked else ()) + tuple(t.shape)
                host = torch.empty(shape, dtype=t.dtype)
            (host[i] if stacked else host).copy_(t)
    return host.numpy() if keep else None


def to_jax_named(state: TrainState, *, keep: bool = True
                 ) -> Dict[str, np.ndarray]:
    """A port ``TrainState`` as ``{name: host array}`` in the names and
    the order ``repro.utils.tree.flatten_with_names`` gives a JAX
    ``TrainState`` of the same model: params under ``0/``, the AdamW step
    (0-d int32) and moments under ``1/``, the error feedback under ``2/``
    (absent without compression).  A sharded state (``state.plan``) has
    each planned leaf gathered to its global shape first, one layer's
    tensor at a time, over the batch axes and ``"model"``: every rank of
    the group must call this, in the same order; a rank called without
    ``keep`` takes part in the gathers, keeps no host copy and gets an
    empty dict (the checkpointer's ranks past 0)."""
    params, cfg = state.params, state.model.cfg
    layout = jax_layout(params, cfg.num_layers, cfg.encoder_layers)
    out: Dict[str, np.ndarray] = {}

    def put(prefix, tree):
        def leaf(n):
            if state.plan is None:
                return tree[n]
            return state.plan.full(n, tree[n])
        for path, names, stacked in layout:
            host = _host_leaf(leaf, names, stacked, keep)
            if keep:
                out[prefix + path] = host

    put("0/", params)
    if keep:
        out["1/.step"] = np.asarray(state.opt.step, np.int32)
    put("1/.mu/", state.opt.mu)
    put("1/.nu/", state.opt.nu)
    if state.err is not None:
        put("2/", state.err)
    return out


@torch.no_grad()
def load_jax_named(template: TrainState, arrays: Mapping,
                   plan=None) -> TrainState:
    """Copy arrays named as ``to_jax_named`` names them (a JAX checkpoint's
    ``np.load``) into ``template``'s tensors in place, leaf by leaf, and
    return a ``TrainState`` over them: the device never holds a second
    state.  The error feedback is read only when ``template`` has one.
    ``plan`` (a ``dp_shard.ShardPlan``): each planned leaf's full array is
    cut to this rank's slice first (over the batch axes and ``"model"``,
    whatever mesh wrote it), and the state returned carries the plan."""
    params, cfg = template.params, template.model.cfg
    layout = jax_layout(params, cfg.num_layers, cfg.encoder_layers)

    def fill(prefix, tree):
        for path, names, stacked in layout:
            a = np.asarray(arrays[prefix + path])
            if stacked and a.shape[0] != len(names):
                raise ValueError(f"{prefix + path}: {a.shape[0]} layers, "
                                 f"the model has {len(names)}")
            for i, n in enumerate(names):
                ai = a[i] if stacked else a
                if plan is not None:
                    ai = plan.local(n, ai)
                if ai.shape != tuple(tree[n].shape):
                    raise ValueError(f"{prefix + path}: shape {ai.shape}, "
                                     f"the model needs "
                                     f"{tuple(tree[n].shape)}")
                tree[n].copy_(torch.from_numpy(np.ascontiguousarray(ai)))

    fill("0/", params)
    fill("1/.mu/", template.opt.mu)
    fill("1/.nu/", template.opt.nu)
    if template.err is not None:
        fill("2/", template.err)
    opt = AdamWState(int(np.asarray(arrays["1/.step"])), template.opt.mu,
                     template.opt.nu)
    return TrainState(template.model, opt, template.err,
                      plan if plan is not None else template.plan)
