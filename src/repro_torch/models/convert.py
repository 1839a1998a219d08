"""Carry parameters and train states from the JAX package into the port.

``from_jax_params(cfg, tree, device=...)`` takes the tree ``repro``'s model builds
(``jax.tree_util.tree_map(np.asarray, model.init(key))``: nested dicts of
numpy arrays, per-layer leaves stacked on a leading ``(L, ...)`` axis) and
loads it into the port's ``DecoderLM``, layer by layer: the dense leaves
and the twelve SSM leaves of a mamba2 layer (``A_log, D, conv_b, conv_w,
dt_bias, gate_norm, in_B, in_C, in_dt, in_x, in_z, out``).  Both packages
keep weights as ``(d_in, d_out)`` and compute ``x @ W``, so nothing is
transposed.

``from_jax_train_state`` carries a whole JAX ``TrainState`` with numpy
leaves (params, AdamW step / mu / nu, error feedback).  ``named_from_tree``
maps JAX's stacked layout to the port's parameter names (``embed.tokens``,
``layers.3.ssm.in_x``, ...).  This module does not import JAX.
"""
from __future__ import annotations

from typing import Dict

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
