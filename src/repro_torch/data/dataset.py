"""Dataset = Storage + transform + collate.

Mirrors the four-step dataloader pipeline from the paper §2.1: (1) load from
storage, (2) transform to model-ready form, (3) shuffle/batch (sampler), (4)
prefetch (worker pool / device prefetcher).

Two collation paths (DESIGN.md §3):

* **per-sample (legacy)** — B ``storage.read`` calls, B Python transform
  calls, ``np.stack`` over B tiny arrays per field;
* **batched fast path** — one ``storage.read_batch`` gather + one vectorized
  transform over the stacked ``(B, ...)`` raw block, optionally writing
  straight into a preallocated slab (``out=``) so nothing is allocated.

The fast path engages when the transform advertises a vectorized variant:
either pass ``batch_transform=`` explicitly, or set ``fn.batch_aware = True``
and ``fn.batch_variant = <vectorized fn>`` on the per-sample transform
(``image_transform`` and the token transform ship both).  Anything else —
ragged items, a plain transform, a transform swapped in after construction —
falls back to the per-sample path with identical results.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.data.storage import ArrayStorage, Storage, StorageProfile
from repro_torch.utils.fingerprint import dataset_fingerprint


class Dataset:
    def __init__(self, storage: Storage, transform: Optional[Callable] = None,
                 collate: Optional[Callable] = None,
                 batch_transform: Optional[Callable] = None):
        self.storage = storage
        self.transform = transform or (lambda x: x)
        self.collate = collate or default_collate
        self._batch_transform = batch_transform

    def __len__(self):
        return len(self.storage)

    @property
    def batch_transform(self) -> Optional[Callable]:
        """The vectorized transform, if any — explicit ``batch_transform=``
        wins, else the live ``transform``'s advertised ``batch_variant``
        (looked up per call so swapping ``transform`` disables it too)."""
        if self._batch_transform is not None:
            return self._batch_transform
        if getattr(self.transform, "batch_aware", False):
            return getattr(self.transform, "batch_variant", None)
        return None

    @property
    def supports_fast_path(self) -> bool:
        return self.batch_transform is not None

    def get(self, idx: int):
        return self.transform(self.storage.read(idx))

    def get_batch(self, indices, *, out: Optional[Dict] = None,
                  fast: bool = True) -> Dict[str, np.ndarray]:
        """Collate the batch at ``indices``.

        ``fast=True`` (default) uses the batched read + vectorized transform
        when available; ``out`` is a dict of preallocated per-field arrays
        (an arena slot) to collate into — ignored (fresh arrays returned) if
        its batch dimension doesn't match ``len(indices)``.
        """
        bt = self.batch_transform if fast else None
        if bt is not None:
            raw = self.storage.read_batch(indices)
            stacked = raw if isinstance(raw, np.ndarray) else _try_stack(raw)
            if stacked is not None:
                if out is not None and not _out_fits(out, len(indices)):
                    out = None
                return bt(stacked, out=out)
            # ragged items: collate per-sample from the raw batch already in
            # hand (storage was charged once — don't read it again)
            return self.collate([self.transform(r) for r in raw])
        return self.collate([self.get(int(i)) for i in indices])

    def with_storage(self, storage: Storage) -> "Dataset":
        """Same transform/collate pipeline over a different storage — how
        the loader derives its cache-tier read view (``CachedStorage``)
        without copying transform wiring."""
        return Dataset(storage, transform=self.transform,
                       collate=self.collate,
                       batch_transform=self._batch_transform)

    def fingerprint(self) -> str:
        p = self.storage.profile()
        return dataset_fingerprint(item_bytes=p.item_bytes,
                                   decode_cost=p.decode_cpu_s_per_byte,
                                   num_items=p.num_items,
                                   item_bytes_std=p.item_bytes_std)


def _try_stack(items) -> Optional[np.ndarray]:
    try:
        return np.stack(items)
    except ValueError:      # ragged items -> per-sample fallback
        return None


def _out_fits(out: Dict[str, np.ndarray], batch: int) -> bool:
    return all(np.asarray(v).ndim >= 1 and np.asarray(v).shape[0] == batch
               for v in out.values())


def out_matches(out: Optional[Dict], spec: Dict[str, tuple]) -> bool:
    """Does ``out`` provide exactly the fields in ``spec`` ({name: (shape,
    dtype)})?  Batch transforms use this to reject a stale slab (e.g. the
    dataset was swapped under a persistent arena) instead of broadcasting
    into it or crashing."""
    if out is None:
        return False
    return set(out) == set(spec) and all(
        out[k].shape == shape and out[k].dtype == np.dtype(dtype)
        for k, (shape, dtype) in spec.items())


def default_collate(samples):
    """Stack a list of dict-or-array samples into batched arrays."""
    if isinstance(samples[0], dict):
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    return {"x": np.stack(samples)}


def image_transform(sample: np.ndarray, *, normalize: bool = True,
                    extra_flops: int = 0) -> Dict[str, np.ndarray]:
    """Decode-ish transform: cast, normalize, optional extra CPU work knob."""
    x = np.asarray(sample, dtype=np.float32)
    if normalize:
        x = x / 255.0 - 0.5
    for _ in range(extra_flops):
        x = x * 1.0000001  # tunable CPU burn for tests
    return {"image": x, "label": np.int32(0)}


def image_batch_transform(raw: np.ndarray, *, out: Optional[Dict] = None,
                          normalize: bool = True,
                          extra_flops: int = 0) -> Dict[str, np.ndarray]:
    """Vectorized ``image_transform`` over a stacked ``(B, ...)`` raw block.

    Byte-identical to per-sample: same cast, same ufunc chain, same dtypes —
    just one C call per op instead of B, and in-place into ``out`` slabs.
    """
    b = raw.shape[0]
    spec = {"image": (raw.shape, np.float32), "label": ((b,), np.int32)}
    if not out_matches(out, spec):
        out = {k: np.empty(shape, dtype) for k, (shape, dtype) in spec.items()}
    img = out["image"]
    img[...] = raw                       # uint8 -> float32 cast
    if normalize:
        np.divide(img, 255.0, out=img)
        np.subtract(img, 0.5, out=img)
    for _ in range(extra_flops):
        np.multiply(img, 1.0000001, out=img)
    out["label"][...] = 0
    return out


image_transform.batch_aware = True
image_transform.batch_variant = image_batch_transform


def synthetic_image_dataset(num_items: int, resolution: int,
                            seed: int = 0) -> Dataset:
    """In-memory uint8 image dataset (CIFAR/COCO stand-in for tests)."""
    rng = np.random.default_rng(seed)
    items = [rng.integers(0, 255, (resolution, resolution, 3),
                          dtype=np.uint8) for _ in range(num_items)]
    return Dataset(ArrayStorage(items), transform=image_transform)


def token_dataset(num_items: int, seq_len: int, vocab: int,
                  seed: int = 0) -> Dataset:
    """Pre-tokenized LM dataset: items are (seq_len+1,) int32 sequences."""
    rng = np.random.default_rng(seed)
    items = [rng.integers(0, vocab, (seq_len + 1,)).astype(np.int32)
             for _ in range(num_items)]

    def transform(arr):
        return {"tokens": arr[:-1], "targets": arr[1:],
                "loss_mask": np.ones(seq_len, np.float32)}

    def batch_transform(raw, *, out=None):
        b = raw.shape[0]
        spec = {"tokens": ((b, seq_len), np.int32),
                "targets": ((b, seq_len), np.int32),
                "loss_mask": ((b, seq_len), np.float32)}
        if not out_matches(out, spec):
            out = {k: np.empty(shape, dtype)
                   for k, (shape, dtype) in spec.items()}
        out["tokens"][...] = raw[:, :-1]
        out["targets"][...] = raw[:, 1:]
        out["loss_mask"][...] = 1.0
        return out

    transform.batch_aware = True
    transform.batch_variant = batch_transform
    return Dataset(ArrayStorage(items), transform=transform)
