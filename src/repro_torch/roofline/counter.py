"""Count what one rank's step computes, moves and holds: the counterpart of
``repro/roofline/hlo_parser.py``.

``repro`` reads the optimized HLO of a compiled step.  Eager PyTorch has
no HLO, so this module parses nothing: ``Counter`` is a
``TorchDispatchMode`` that sees every aten op the step runs, on any
device (``meta`` included), and counts as ``hlo_parser`` counted:

* FLOPs: ``torch.utils.flop_counter``'s registered formulas (matrix
  products, convolutions, attention), where ``hlo_parser`` counted its
  dots and convolutions;
* traffic: each op reads its operands and writes its results, the
  post-fusion model at aten granularity.  A view costs nothing; a gather
  (``index``, ``index_select``, ``gather``, ``embedding``) costs twice its
  result and a scatter (``index_put``, ``scatter``, ``index_add``, the
  ``*_scatter`` ops) twice its update, as ``hlo_parser.py``'s slices and
  dynamic-update-slices;
* live bytes and their peak, by storage (views share one): a storage
  made by an op counts until it is freed (a weak reference to the storage
  object, since every meta tensor's ``data_ptr()`` is 0);
* for each op, the module path that called it (the innermost frame of
  the port outside this package) and the scope of the parameters it
  touched (``layers.3``), for ``top_traffic`` and per-layer totals.

Kernel regions.  The kernels' entry points (``kernels/ops.py``, the
split-row pair in ``kernels/rmsnorm.py``) and their autograd backwards
open a region (``region``).  Inside one the aten ops count for nothing;
the region adds its ``costs.py`` formula under the kernel's name, and the
tensors it ``keep``s (its outputs, what its backward saves) count as
live from then on, with its declared scratch on top while it runs.  So a
step counts the same FLOPs, traffic and peak on meta (the kernels' shape
functions), on the CPU (their plain twins) and on the card (the kernels).
Regions nest: only the outermost counts.  The backward runs on autograd's
threads; the mode's state travels with autograd's thread-local state
(as ``FlopCounterMode``'s does), and the region depth is kept per thread.

Collectives.  ``distributed/transport.py`` reports each collective it
issues (``collective``): its kind, the mesh axis of its group and its
bytes, max(input, output), an all-reduce twice that, as
``hlo_parser.py`` counts them.  A collective over a group of one is not
issued and not counted.  The collective ops themselves (the ``c10d``
namespace) are left out of the traffic.

Trip counts have no counterpart: the eager trace runs every layer and
every microbatch of the step (the ``dp_manual`` step's microbatches are
each traced, not weighted).  Not seen: the caching allocator's rounding
and reserve, cuBLAS's workspace, a kernel's scratch that its region does
not declare.
"""
from __future__ import annotations

import collections
import re
import sys
import threading
import weakref
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analysis import NODE_GPUS

_ACTIVE: Optional["Counter"] = None
_tls = threading.local()

_GATHERS = {"index", "index_select", "gather", "embedding",
            "take_along_dim"}
_SCATTERS = {"index_put", "index_put_", "scatter", "scatter_",
             "scatter_add", "scatter_add_", "scatter_reduce",
             "scatter_reduce_", "index_add", "index_add_", "index_copy",
             "index_copy_", "slice_scatter", "select_scatter",
             "diagonal_scatter", "as_strided_scatter"}
# ops that allocate or alias without moving bytes
_FREE = {"_unsafe_view", "empty", "empty_like", "empty_strided",
         "new_empty", "new_empty_strided", "lift_fresh", "detach",
         "alias", "set_", "resize_", "_local_scalar_dense", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size"}
_LAYER = re.compile(r"^((?:layers|encoder)\.\d+)\.")
_PKG = f"repro_torch{__import__('os').sep}"
_SELF = ("roofline", "kernels")


def active() -> Optional["Counter"]:
    """The counter counting now, or None."""
    return _ACTIVE


def _depth() -> int:
    return getattr(_tls, "depth", 0)


_VIEWS: Dict[object, bool] = {}


def _is_view(func) -> bool:
    v = _VIEWS.get(func)
    if v is None:
        v = _VIEWS[func] = any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns)
    return v


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes; a scalar (0-dim) counts none: it travels as a
    kernel's argument, and how one is made differs by device."""
    return t.numel() * t.element_size() if t.dim() else 0


def _tensors(x, out=None) -> list:
    """The tensors in nested tuples, lists and dicts (an op's arguments
    and results), in order."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _caller() -> str:
    """The innermost frame of the port outside this package and the
    kernels: ``module.function``, or ``backward`` where there is none
    (autograd's engine called the op)."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        i = fn.rfind(_PKG)
        if i >= 0:
            mod = fn[i + len(_PKG):-3].replace("/", ".").replace("\\", ".")
            if not mod.startswith(_SELF):
                return f"{mod}.{f.f_code.co_name}"
        f = f.f_back
    return "backward"


class _NullRegion:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullRegion()


class _Region:
    def __init__(self, counter, name, flops, nbytes, scratch):
        self.counter, self.name = counter, name
        self.flops, self.nbytes, self.scratch = flops, nbytes, scratch

    def __enter__(self):
        _tls.depth = _depth() + 1
        return self

    def __exit__(self, *exc):
        _tls.depth = _depth() - 1
        if exc[0] is None:
            self.counter._kernel(self.name, self.flops, self.nbytes,
                                 self.scratch)
        return False


def region(name: str, cost, *, scratch: int = 0):
    """A kernel region named ``name`` (a context manager): ``cost()``
    returns its (flops, bytes) (``costs.py``), called only while a counter
    counts and the region is the outermost; ``scratch``: bytes the kernel
    allocates and frees inside it.  A no-op when nothing counts."""
    c = _ACTIVE
    if c is None:
        return _NULL
    if _depth() > 0:
        return _Nested()
    flops, nbytes = cost()
    return _Region(c, name, float(flops), float(nbytes), int(scratch))


class _Nested(_NullRegion):
    def __enter__(self):
        _tls.depth = _depth() + 1
        return self

    def __exit__(self, *exc):
        _tls.depth = _depth() - 1
        return False


def keep(*tensors) -> None:
    """Count the storages of ``tensors`` (a region's outputs, or what it
    saves for its backward) as live from now on, if a counter counts."""
    c = _ACTIVE
    if c is not None:
        for t in tensors:
            if isinstance(t, torch.Tensor):
                c._track(t)


def collective(kind: str, group, nbytes: int) -> None:
    """Record one collective issued over ``group``: ``kind`` as
    ``transport`` tallies it, ``nbytes`` max(input, output); an
    all-reduce counts twice its bytes.  The mesh axis is the one of the
    current ``use_rules`` mesh whose group is ``group``."""
    c = _ACTIVE
    if c is None:
        return
    from repro_torch.distributed.sharding_rules import current_ctx
    ctx = current_ctx()
    axis = "?"
    if ctx is not None:
        for a in ctx.mesh.mesh_dim_names:
            if ctx.mesh.get_group(a) is group or \
                    ctx.mesh.get_group(a) == group:
                axis = a
                break
    if axis not in c.axis_intra_node:
        ranks = dist.get_process_group_ranks(group)
        c.axis_intra_node[axis] = len({r // NODE_GPUS for r in ranks}) == 1
    b = float(nbytes) * (2 if kind.startswith("all_reduce") else 1)
    with c._lock:
        c.collective_bytes[kind] += b
        c.collective_counts[kind] += 1
        c.collective_axes[axis] += b
        key = (kind, axis, _caller())
        c.collective_calls[key][0] += 1
        c.collective_calls[key][1] += b


class Counter(TorchDispatchMode):
    """Counts one rank's work while entered (``with Counter() as c:``).
    ``names``: {name: tensor} of the parameters and optimizer state, whose
    storages name the scope of an op that touches them.

    Totals: ``flops``, ``traffic`` (bytes), ``peak`` (the most live bytes
    made while counting, scratch included), ``kernels`` ({name: {regions,
    flops, bytes}}), ``collective_bytes`` / ``collective_counts`` by kind,
    ``collective_axes`` bytes by mesh axis (``axis_intra_node`` whether
    its group lies in one node), ``ops`` ({(path, op): [count, flops,
    bytes]}), ``scopes`` ({scope: [flops, bytes]}), ``collective_calls``
    ({(kind, axis, path): [count, bytes]})."""

    def __init__(self, names: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.flops = 0.0
        self.traffic = 0.0
        self.live = 0
        self.peak = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.collective_bytes: collections.Counter = collections.Counter()
        self.collective_counts: collections.Counter = collections.Counter()
        self.collective_axes: collections.Counter = collections.Counter()
        self.axis_intra_node: Dict[str, bool] = {}
        self.collective_calls = collections.defaultdict(lambda: [0, 0.0])
        self.ops = collections.defaultdict(lambda: [0, 0.0, 0.0])
        self.scopes = collections.defaultdict(lambda: [0.0, 0.0])
        self._scope_of: Dict[int, str] = {}
        self._live: Dict[int, int] = {}
        self._lock = threading.RLock()
        self._scope = "-"
        # by tensor, not storage: a stacked leaf's layers share one
        for name, t in (names or {}).items():
            m = _LAYER.match(name)
            self._scope_of[id(t)] = m.group(1) if m else name.split(".")[0]

    # -- entering and leaving ------------------------------------------------
    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a Counter is already counting")
        _ACTIVE = self
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        return super().__exit__(*exc)

    # -- memory --------------------------------------------------------------
    def _track(self, t: torch.Tensor, scratch: int = 0) -> None:
        if not t.dim():
            return
        st = t.untyped_storage()
        key = id(st)
        with self._lock:
            if key in self._live:
                return
            n = st.nbytes()
            self._live[key] = n
            self.live += n
            self.peak = max(self.peak, self.live + scratch)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        with self._lock:
            self.live -= self._live.pop(key, 0)

    # -- scopes --------------------------------------------------------------
    def _set_scope(self, ins) -> None:
        """The scope of an op: that of a named tensor among its inputs;
        in the backward, that of the nearest named leaf the autograd node
        running it reaches; else the scope of the op before it."""
        for t in ins:
            s = self._scope_of.get(id(t))
            if s is not None:
                self._scope = s
                return
        node = torch._C._current_autograd_node()
        if node is None:
            return
        frontier, seen = [node], set()
        for _ in range(6):
            nxt = []
            for n in frontier:
                for fn, _ in n.next_functions:
                    if fn is None or id(fn) in seen:
                        continue
                    seen.add(id(fn))
                    var = getattr(fn, "variable", None)
                    if var is not None:
                        s = self._scope_of.get(id(var))
                        if s is not None:
                            self._scope = s
                            return
                    nxt.append(fn)
            frontier = nxt

    # -- counting ------------------------------------------------------------
    def _add(self, path, op, flops, nbytes) -> None:
        with self._lock:
            self.flops += flops
            self.traffic += nbytes
            row = self.ops[(path, op)]
            row[0] += 1
            row[1] += flops
            row[2] += nbytes
            s = self.scopes[self._scope]
            s[0] += flops
            s[1] += nbytes

    def _kernel(self, name, flops, nbytes, scratch) -> None:
        with self._lock:
            k = self.kernels.setdefault(name, {"regions": 0, "flops": 0.0,
                                               "bytes": 0.0})
            k["regions"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
            self.peak = max(self.peak, self.live + scratch)
        self._add(_caller(), f"kernel:{name}", flops, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _depth() > 0 or func.namespace in ("c10d", "_c10d_functional"):
            return out
        ins = _tensors((args, kwargs))
        if self._scope_of:
            self._set_scope(ins)
        outs = _tensors(out)
        name = func._overloadpacket.__name__
        flops = 0.0
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            flops = float(fn(*args, **kwargs, out_val=out))
        if name in _FREE or _is_view(func):
            nbytes = 0.0
        elif name in _GATHERS:
            nbytes = 2.0 * sum(_nbytes(t) for t in outs)
        elif name in _SCATTERS:
            nbytes = 2.0 * _nbytes(ins[-1]) if ins else 0.0
        else:
            nbytes = float(sum(_nbytes(t) for t in ins)
                           + sum(_nbytes(t) for t in outs))
        if flops or nbytes:
            self._add(_caller(), name, flops, nbytes)
        if outs:
            held = {id(t.untyped_storage()) for t in ins}
            for t in outs:
                if id(t.untyped_storage()) not in held:
                    self._track(t)
        return out

    # -- reading -------------------------------------------------------------
    def kernel_totals(self) -> Dict[str, float]:
        """FLOPs and bytes inside kernel regions, and outside them."""
        kf = sum(k["flops"] for k in self.kernels.values())
        kb = sum(k["bytes"] for k in self.kernels.values())
        return {"kernel_flops": kf, "kernel_bytes": kb,
                "other_flops": self.flops - kf,
                "other_bytes": self.traffic - kb}

    def top_traffic(self, n: int = 15):
        """[(bytes, count, flops, op, path)] of the n heaviest (path, op)
        pairs by traffic."""
        rows = [(v[2], v[0], v[1], op, path)
                for (path, op), v in self.ops.items()]
        rows.sort(reverse=True)
        return rows[:n]

    def summary(self) -> dict:
        """The totals as plain numbers (what a test or a report holds)."""
        return {"flops": self.flops, "traffic": self.traffic,
                "peak": self.peak,
                "kernels": {k: dict(v) for k, v in
                            sorted(self.kernels.items())},
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "collective_axes": dict(self.collective_axes)}
