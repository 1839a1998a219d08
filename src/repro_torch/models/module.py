"""Parameter specs: shapes and init kinds, and parameters drawn from them.

The spec tree has the JAX package's layout (``repro/models/module.py``):
nested dicts of ``ParamSpec`` with per-layer leaves stacked on a leading
``(L, ...)`` axis.  ``init_params`` draws fp32 masters from an explicit
``torch.Generator``; its numbers differ from JAX's PRNG for the same seed,
so tests carry JAX's parameters across instead (``convert.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis per dim
    init: str = "normal"                     # normal | zeros | ones | embed
    scale: Optional[float] = None            # stddev override
    fan_in_dims: Tuple[int, ...] = (0,)      # dims treated as fan-in for scale

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"ParamSpec rank mismatch: shape {self.shape} vs axes {self.axes}")

    @property
    def fan_in(self) -> int:
        return int(np.prod([self.shape[d] for d in self.fan_in_dims])) or 1

    @property
    def std(self) -> float:
        if self.scale is not None:
            return self.scale
        return 1.0 if self.init == "embed" else 1.0 / float(np.sqrt(self.fan_in))


def spec(shape, axes, init="normal", scale=None, fan_in_dims=(0,)) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), init, scale, tuple(fan_in_dims))


def stacked(s: ParamSpec, num_layers: int) -> ParamSpec:
    """Stack a per-layer spec along a leading 'layers' axis."""
    return ParamSpec((num_layers,) + s.shape, ("layers",) + s.axes, s.init,
                     s.scale, tuple(d + 1 for d in s.fan_in_dims))


def map_specs(fn, tree):
    """Apply ``fn`` to every ParamSpec leaf of a nested dict."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    return {k: map_specs(fn, v) for k, v in tree.items()}


def stack_specs(tree, num_layers: int):
    return map_specs(lambda s: stacked(s, num_layers), tree)


def init_params(specs, generator: torch.Generator, shard=None):
    """fp32 parameters for a spec tree, drawn on the generator's device.
    ``shard(path, full)``: each leaf, given its path of keys and drawn
    whole, replaced by the tensor it returns (a rank's copy of its shard)
    before the next leaf is drawn, so only one whole leaf is held at a
    time; the numbers are those of the whole tree's."""
    device = generator.device

    def leaf(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, device=device)
        t = torch.empty(s.shape, device=device)
        return t.normal_(0.0, s.std, generator=generator)

    def walk(tree, path):
        if isinstance(tree, ParamSpec):
            t = leaf(tree)
            return t if shard is None else shard(path, t)
        return {k: walk(v, path + (k,)) for k, v in tree.items()}

    return walk(specs, ())
