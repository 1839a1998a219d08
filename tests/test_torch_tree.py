"""The port's tree helpers (``repro_torch/utils/tree.py``) against
``repro.utils.tree`` on the same seeded nested trees: element and byte
counts, names and their order (a dict's keys sorted, as JAX flattens it),
bf16 and fp8 leaves, named tuples, ``None`` subtrees, meta tensors."""
from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.utils import tree as jtree

from repro_torch import utils as tutils
from repro_torch.utils import tree as ttree

Moments = collections.namedtuple("Moments", "mu nu")
DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16),
          ("float8_e4m3fn", torch.float8_e4m3fn, jnp.float8_e4m3fn),
          ("int32", torch.int32, jnp.int32)]


def _trees(seed: int):
    """The same random nested tree twice: (torch leaves, jax leaves).
    Keys are inserted out of order, so a walk in insertion order would
    name them differently from JAX's sorted one."""
    rng = np.random.default_rng(seed)

    def leaf():
        _, td, jd = DTYPES[rng.integers(len(DTYPES))]
        shape = tuple(int(d) for d in rng.integers(1, 5, rng.integers(0, 4)))
        x = rng.normal(size=shape).astype(np.float32)
        return torch.from_numpy(x).to(td), jnp.asarray(x).astype(jd)

    def node(depth):
        kind = rng.integers(5) if depth < 3 else 4
        if kind == 0:
            keys = [f"k{int(i)}" for i in rng.permutation(4)[:3]]
            kids = {k: node(depth + 1) for k in keys}
            return ({k: v[0] for k, v in kids.items()},
                    {k: v[1] for k, v in kids.items()})
        if kind in (1, 2):
            kids = [node(depth + 1) for _ in range(rng.integers(1, 4))]
            typ = list if kind == 1 else tuple
            return typ(k[0] for k in kids), typ(k[1] for k in kids)
        if kind == 3:
            a, b = node(depth + 1), node(depth + 1)
            return Moments(a[0], b[0]), Moments(a[1], b[1])
        return leaf()

    t, j = node(0)
    lt, lj = leaf()
    return ({"z": t, "a": [None, 2.5], "m": Moments(lt, lt)},
            {"z": j, "a": [None, 2.5], "m": Moments(lj, lj)})


@pytest.mark.parametrize("seed", range(6))
def test_torch_tree_counts_and_names_match_jax(seed):
    t, j = _trees(seed)
    assert ttree.tree_count(t) == jtree.tree_count(j)
    assert ttree.tree_bytes(t) == jtree.tree_bytes(j)
    names_t = [n for n, _ in ttree.flatten_with_names(t)]
    names_j = [n for n, _ in jtree.flatten_with_names(j)]
    assert names_t == names_j
    for (_, a), (_, b) in zip(ttree.flatten_with_names(t),
                              jtree.flatten_with_names(j)):
        if isinstance(a, torch.Tensor):
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))


@pytest.mark.parametrize("seed", range(3))
def test_torch_tree_map_with_path_str_matches_jax(seed):
    t, j = _trees(seed)

    def tag(path, leaf):
        return f"{path}:{tuple(getattr(leaf, 'shape', ()))}"

    got = ttree.flatten_with_names(ttree.tree_map_with_path_str(tag, t))
    want = jtree.flatten_with_names(jtree.tree_map_with_path_str(tag, j))
    assert got == want


@pytest.mark.parametrize("name,td,jd", DTYPES, ids=[d[0] for d in DTYPES])
def test_torch_tree_bytes_by_dtype_and_on_meta(name, td, jd):
    """bf16 and fp8 leaves count their own widths, and a meta tensor
    (the dry-run's) counts what the tensor would hold."""
    shape = (3, 5, 7)
    assert ttree.tree_bytes({"x": torch.zeros(shape, dtype=td)}) == \
        jtree.tree_bytes({"x": jnp.zeros(shape, jd)})
    assert ttree.tree_bytes([torch.empty(shape, dtype=td, device="meta")]) \
        == jtree.tree_bytes([jnp.zeros(shape, jd)])


def test_torch_tree_exported_from_utils():
    """``repro_torch.utils`` exports the four helpers, as
    ``repro.utils`` does."""
    for name in ("tree_bytes", "tree_count", "tree_map_with_path_str",
                 "flatten_with_names"):
        assert getattr(tutils, name) is getattr(ttree, name)
