"""Collective (overlapped all-gather) matmul over a ring of ranks.

The counterpart of ``repro/distributed/collective_matmul.py``: instead of
``all_gather(w) @`` (a burst of traffic, then compute) the gather is split
into ring steps, each multiplying the weight shard a rank holds while the
next shard passes around the ring (``model_axis.ppermute``).  The local
product is ``torch.matmul``, as ``repro`` computes it with ``jnp.dot``
outside any kernel.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import model_axis


def ring_weight_matmul(x: torch.Tensor, w: torch.Tensor, mesh, *,
                       axis: str = "model") -> torch.Tensor:
    """x: this rank's (m / n, k) rows of an m-sharded x; w: its (k, f / n)
    columns of an f-sharded w, n the size of ``axis``.  Returns this
    rank's rows of x @ w, (m / n, f) in fp32: at step i the rank
    multiplies the shard that started on rank (rank - i) mod n, writes it
    at that shard's columns and passes it on."""
    n = mesh.shape[mesh.mesh_dim_names.index(axis)]
    split = model_axis.Split(axis, n, mesh.get_local_rank(axis),
                             mesh.get_group(axis))
    fs = w.shape[1]
    out = torch.empty((x.shape[0], n * fs), dtype=torch.float32,
                      device=x.device)
    blk = w.contiguous()
    for i in range(n):
        wait = model_axis.ppermute(blk, split) if i < n - 1 else None
        src = (split.rank - i) % n
        out[:, src * fs:(src + 1) * fs] = torch.matmul(x, blk).float()
        if wait is not None:
            blk = wait()
    return out
