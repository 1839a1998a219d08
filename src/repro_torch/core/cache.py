"""DPT result cache (paper §5: "parameters deduced by DPT can be used for
datasets with similar characteristics" on the same machine).

Keyed by (machine fingerprint, dataset fingerprint, batch-size bucket,
epoch class).  Dataset fingerprints bucket item size / decode cost in
half-octave bins, so e.g. two ~100KB-JPEG folders share tuned parameters
while 80x80 and 640x640 resizes do not.
"""
from __future__ import annotations

import json
import math
import os
import threading
from typing import Optional, Tuple

from repro_torch.core.dpt import DPTResult


def _batch_bucket(batch_size: int) -> int:
    return int(round(math.log2(max(batch_size, 1))))


# the beyond-paper axes, in tuple order: (axis name, DPTResult/Trial field).
# Every axis follows the same lifecycle — an entry records the winning
# value plus a "<axis>_searched" flag (did the sweep actually price the
# axis?), reads can require a searched axis, and an axis-blind refinement
# must never clobber a searched value back to 0.  One table instead of a
# copy of that logic per axis.
_AXES: Tuple[Tuple[str, str], ...] = (
    ("locality", "locality_chunk"),
    ("cache", "cache_budget_bytes"),
    ("slow_lane", "slow_lane_workers"),
    ("geometry", "global_batch"),
)


class DPTCache:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._store: dict = {}
        if path and os.path.exists(path):
            with open(path) as f:
                self._store = json.load(f)

    def _key(self, machine_fp: str, dataset_fp: str, batch_size: int,
             epoch: int) -> str:
        epoch_class = "cold" if epoch == 0 else "warm"
        return f"{machine_fp}|{dataset_fp}|b{_batch_bucket(batch_size)}|{epoch_class}"

    def get(self, machine_fp: str, dataset_fp: str, batch_size: int,
            epoch: int = 0) -> Optional[Tuple[int, int]]:
        with self._lock:
            v = self._store.get(self._key(machine_fp, dataset_fp,
                                          batch_size, epoch))
        return (v["nworker"], v["nprefetch"]) if v else None

    def get_params(self, machine_fp: str, dataset_fp: str, batch_size: int,
                   epoch: int = 0, *, require_locality: bool = False,
                   require_cache: bool = False, with_cache: bool = False,
                   require_slow_lane: bool = False,
                   with_slow_lane: bool = False,
                   require_geometry: bool = False,
                   with_geometry: bool = False
                   ) -> Optional[Tuple[int, ...]]:
        """Like ``get`` but with the locality axis: (nworker, nprefetch,
        locality_chunk).  Entries written before the axis existed read
        back as locality 0 (random order).  ``require_locality=True``
        treats entries whose search never swept the axis as misses — a
        run that newly enables the axis must not be satisfied by a stale
        two-axis result.

        Every later axis is opt-in, so the 3-tuple contract above is
        unchanged for existing callers; ``with_<axis>=True`` appends the
        axis value in ``_AXES`` order (cache budget, slow-lane workers,
        geometry global batch) and ``require_<axis>=True`` treats entries
        whose search never swept that axis as misses — the same staleness
        rule applied uniformly through the axis table."""
        require = {"locality": require_locality, "cache": require_cache,
                   "slow_lane": require_slow_lane,
                   "geometry": require_geometry}
        append = {"cache": with_cache, "slow_lane": with_slow_lane,
                  "geometry": with_geometry}
        with self._lock:
            v = self._store.get(self._key(machine_fp, dataset_fp,
                                          batch_size, epoch))
        if not v:
            return None
        for axis, _field in _AXES:
            if require[axis] and not v.get(f"{axis}_searched", False):
                return None
        out = (v["nworker"], v["nprefetch"],
               int(v.get("locality_chunk", 0)))
        for axis, field in _AXES:
            if append.get(axis):
                out = out + (int(v.get(field, 0)),)
        return out

    def put(self, machine_fp: str, dataset_fp: str, batch_size: int,
            result: DPTResult, epoch: int = 0) -> None:
        key = self._key(machine_fp, dataset_fp, batch_size, epoch)
        entry = {
            "nworker": result.nworker,
            "nprefetch": result.nprefetch,
            "optimal_time": result.optimal_time,
        }
        for axis, field in _AXES:
            entry[field] = getattr(result, field, 0)
            # did the sweep actually price the axis?  any non-zero value
            # among the trials means candidates were measured (a searched
            # axis always includes one)
            entry[f"{axis}_searched"] = any(
                getattr(t, field, 0) for t in result.trials)
        with self._lock:
            prev = self._store.get(key)
            for axis, field in _AXES:
                if (not entry[f"{axis}_searched"] and prev
                        and prev.get(f"{axis}_searched")):
                    # an axis-blind refinement (e.g. an online 2-axis
                    # retune) was measured AT the live value: it refines
                    # (nworker, nprefetch) without invalidating the
                    # searched axis — keep it instead of clobbering to 0
                    entry[field] = prev.get(field, 0)
                    entry[f"{axis}_searched"] = True
            self._store[key] = entry
            if self.path:
                tmp = self.path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(self._store, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)

    def __len__(self):
        return len(self._store)
