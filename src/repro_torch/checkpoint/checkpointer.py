"""Async, atomic checkpointing in ``repro``'s on-disk layout (no external
deps).

Layout per step, the same files and names as ``repro``'s checkpointer::

    <root>/step_00001234.tmp/            # staged, then atomically renamed
        arrays_p0.npz                    # this process's leaves
        manifest.json                    # leaf names/shapes/dtypes
        aux.json                         # sampler state, loader params

A port ``TrainState`` is written as ``repro`` writes a JAX ``TrainState``
of the same model (``models/convert.py:to_jax_named``: per-layer leaves
stacked on a leading ``(L, ...)`` axis, ``1/.step`` and the AdamW moments,
``2/...`` for the error feedback), so either package restores what the
other saved.  Any other state is a nested dict of tensors or arrays, named
as ``repro.utils.tree.flatten_with_names`` names a dict (keys sorted, joined
by ``/``).  The process index in the file name is the ``torch.distributed``
rank when a group is up, else 0.

Sharded states (the storage plan of ``train_step.param_plan``, over the
batch axes and ``"model"``): a save gathers each leaf, one layer's tensor
at a time, to its global shape; rank 0 alone keeps the host copy and
writes the files, names and bytes a world-1 save writes, while the other
ranks wait at a barrier; ``restore(template, shardings=plan)`` reads the
global leaves and keeps this rank's slice of each planned leaf, as
``jax.device_put(arr, sharding)`` does in ``repro``.  So a checkpoint
written at one (data, model) size restores at any other.

Async: ``save`` copies the leaves to host memory synchronously (the
device-to-host part, each stacked leaf straight into one array allocated
up front) and writes them in a background thread, so the train loop only
blocks if a previous save is still in flight (at most one at a time:
checkpoint cadence faster than disk means you want backpressure, not OOM).
``restore`` into a ``TrainState`` copies into the template's tensors in
place, leaf by leaf, so the device never holds two states.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.convert import load_jax_named, to_jax_named
from repro_torch.train.train_step import TrainState


def process_index() -> int:
    """This process's rank in the ``torch.distributed`` group, else 0."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _flatten(tree, path: Tuple[str, ...] = ()):
    """[(name, leaf), ...] of a nested dict in sorted-key order (None
    values hold no leaf, as in a JAX pytree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k],
                                                            path + (str(k),))]
    return [("/".join(path), tree)]


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        host = torch.empty(leaf.shape, dtype=leaf.dtype)
        with torch.no_grad():
            host.copy_(leaf)
        return host.numpy()
    return np.array(leaf)


def _unflatten(tree, arrays, path: Tuple[str, ...] = ()):
    """``tree``'s structure with each leaf read from ``arrays``: a tensor
    on the template leaf's device, or a numpy array."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, arrays, path + (str(k),))
                for k, v in tree.items()}
    arr = arrays["/".join(path)]
    if isinstance(tree, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(tree.device)
    return arr


class Checkpointer:
    def __init__(self, root: str, *, keep_last: int = 3):
        self.root = root
        self.keep_last = keep_last
        os.makedirs(root, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # one record per save: its step, the wall seconds of its host
        # copy (the blocking part) and of its file write (the background
        # part, filled in when the write ends); and the latest restore's
        self.saves: List[Dict[str, Any]] = []
        self.restore_s: Optional[float] = None

    # ---- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ---- save ------------------------------------------------------------------
    def save(self, step: int, state, aux: Optional[Dict[str, Any]] = None,
             *, block: bool = False) -> None:
        """Snapshot ``state`` to the host now and write it in the
        background (at once if ``block``).  A sharded ``TrainState`` is
        saved by every rank of its group together: rank 0 writes, the
        others wait at a barrier until it has, and the save blocks."""
        import torch.distributed as dist
        self.wait()  # backpressure: at most one save in flight
        t0 = time.perf_counter()
        sharded = isinstance(state, TrainState) and state.plan is not None
        if isinstance(state, TrainState):
            host = to_jax_named(state,
                                keep=not sharded or dist.get_rank() == 0)
        else:
            host = {name: _to_host(leaf) for name, leaf in _flatten(state)}
        if sharded and dist.get_rank() != 0:
            dist.barrier()
            return
        record = {"step": step, "snapshot_s": time.perf_counter() - t0,
                  "write_s": None}
        self.saves.append(record)
        aux = dict(aux or {})
        aux["step"] = step

        def _write():
            t1 = time.perf_counter()
            tmp = self._step_dir(step) + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            pid = 0 if sharded else process_index()
            np.savez(os.path.join(tmp, f"arrays_p{pid}.npz"), **host)
            manifest = {n: {"shape": list(a.shape), "dtype": str(a.dtype)}
                        for n, a in host.items()}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "aux.json"), "w") as f:
                json.dump(aux, f)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()
            record["write_s"] = time.perf_counter() - t1

        t = threading.Thread(target=_write, daemon=True)
        t.start()
        with self._lock:
            self._pending = t
        if block or sharded:
            self.wait()
        if sharded:
            dist.barrier()

    def wait(self) -> None:
        with self._lock:
            t = self._pending
        if t is not None:
            t.join()
            with self._lock:
                if self._pending is t:
                    self._pending = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ---- restore -----------------------------------------------------------------
    def restore(self, state_template, step: Optional[int] = None,
                *, shardings=None) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of ``state_template``.  A
        ``TrainState`` template's tensors receive the values in place; a
        nested dict's values are ignored.  ``shardings``: the
        ``dp_shard.ShardPlan`` of a sharded ``TrainState`` template
        (``template.plan``); each planned leaf receives this rank's slice
        of the saved global leaf, whatever world size wrote it."""
        if shardings is not None and not isinstance(state_template,
                                                    TrainState):
            raise TypeError("shardings applies to a TrainState template")
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        t0 = time.perf_counter()
        d = self._step_dir(step)
        path = os.path.join(d, f"arrays_p{process_index()}.npz")
        if not os.path.exists(path):  # elastic restart: host id changed
            path = os.path.join(d, "arrays_p0.npz")
        with open(os.path.join(d, "aux.json")) as f:
            aux = json.load(f)
        with np.load(path) as arrays:
            if isinstance(state_template, TrainState):
                state = load_jax_named(state_template, arrays, shardings)
            else:
                state = _unflatten(state_template, arrays)
        self.restore_s = time.perf_counter() - t0
        return state, aux
