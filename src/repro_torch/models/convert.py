"""Carry a parameter tree from the JAX package into the port.

``from_jax_params(cfg, tree)`` takes the tree ``repro``'s model builds
(``jax.tree_util.tree_map(np.asarray, model.init(key))``: nested dicts of
numpy arrays, per-layer leaves stacked on a leading ``(L, ...)`` axis) and
loads it into the port's ``DecoderLM``, layer by layer.  Both packages keep
weights as ``(d_in, d_out)`` and compute ``x @ W``, so nothing is
transposed.  This module does not import JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import DecoderLM, build_model


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def from_jax_params(cfg: ModelConfig, tree, *, device="cpu") -> DecoderLM:
    return build_model(cfg, _to_torch(tree), device=device)
