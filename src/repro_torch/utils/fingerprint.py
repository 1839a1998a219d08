"""Fingerprints for DPT result reuse (paper §5: tuned parameters "may be reused
on the same machine upon loading data sets that have similar characteristics").

A dataset fingerprint captures the characteristics that drive loader behaviour
(item size distribution, decode cost class, count); a machine fingerprint
captures the host resources that bound the search space (cores, RAM, device
count).  DPT's cache is keyed on both.
"""
from __future__ import annotations

import hashlib
import json
import os
import platform
from dataclasses import asdict, is_dataclass


def _stable_hash(obj) -> str:
    if is_dataclass(obj) and not isinstance(obj, type):
        obj = asdict(obj)
    blob = json.dumps(obj, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def dataset_fingerprint(*, item_bytes: float, decode_cost: float,
                        num_items: int, item_bytes_std: float = 0.0,
                        bucket: bool = True) -> str:
    """Bucketed fingerprint: similar datasets hash identically.

    Bucketing uses order-of-magnitude bins so that e.g. two image folders with
    ~100KB JPEGs share a fingerprint while 80x80 vs 640x640 resolutions do not.
    """
    import math

    def _bin(x: float) -> float:
        if not bucket:
            return x
        if x <= 0:
            return 0.0
        return round(math.log2(max(x, 1e-12)) * 2) / 2  # half-octave bins

    return _stable_hash({
        "item_bytes": _bin(item_bytes),
        "decode_cost": _bin(decode_cost),
        "num_items": _bin(float(num_items)),
        "item_bytes_std": _bin(item_bytes_std),
    })


def machine_fingerprint(*, cpu_count: int | None = None,
                        device_count: int | None = None,
                        host_ram_bytes: int | None = None) -> str:
    if cpu_count is None:
        cpu_count = os.cpu_count() or 1
    if device_count is None:
        import torch

        # at least 1, as ``repro`` counts the CPU device of a host without
        # an accelerator: a DPT cache entry keys the same in both packages
        device_count = max(1, torch.cuda.device_count())
    if host_ram_bytes is None:
        try:
            host_ram_bytes = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        except (ValueError, OSError):  # pragma: no cover
            host_ram_bytes = 0
    return _stable_hash({
        "cpu": cpu_count,
        "devices": device_count,
        "ram_gb": round(host_ram_bytes / 2**30),
        "machine": platform.machine(),
    })
