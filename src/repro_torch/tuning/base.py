"""Unified tuning layer: one protocol, one registry, one front door.

Before this layer, the repo had four tuning entry points with four
signatures (``DPT.run``, ``search.successive_halving``,
``search.tuned_with_warmstart``, ``search.goodput_tune``), each carrying
its own Trial bookkeeping and MemoryOverflow handling.  Now every tuner is
a :class:`TuningStrategy` registered by name, measured through a shared
:class:`TrialRecorder`, and reachable through::

    from repro_torch.tuning import tune
    result = tune(evaluator=ev, strategy="grid", config=DPTConfig(...))

The legacy entry points still exist and delegate here, so nothing that
imported them moves — but new call sites (OnlineTuner, the trainer, the
benchmarks) only need the one function.

How Algorithm 1 maps on:  the paper's grid sweep is the ``"grid"``
strategy (see ``strategies.GridSearch`` — the loop is a line-for-line port
of Algorithm 1 with the final worker rung clamped to N); the evaluator it
measures cells with is unchanged (``core/evaluators.py``); the
``DPTConfig``/``DPTResult``/``Trial`` dataclasses stay in ``core/dpt.py``
because they predate the layer and everything imports them from there.
"""
from __future__ import annotations

import math
from typing import (Dict, List, Optional, Protocol, Sequence, Type, Union,
                    runtime_checkable)

from repro_torch.core.dpt import DPTConfig, DPTResult, Evaluator, Trial
from repro_torch.core.monitor import MemoryOverflow


class TrialRecorder:
    """Shared measurement bookkeeping for every strategy.

    Wraps an evaluator and records one :class:`Trial` per real measurement,
    normalizing the two ways a cell can overflow (the evaluator raising
    ``MemoryOverflow``, or returning ``TransferStats(overflowed=True)``)
    into a single ``math.inf`` score — the semantics Algorithm 1's
    lines 9-10 act on.
    """

    def __init__(self, evaluator: Evaluator, config: DPTConfig):
        self.evaluator = evaluator
        self.config = config
        self.trials: List[Trial] = []

    def seconds(self, nworker: int, nprefetch: int, *,
                num_batches: Optional[int] = None,
                record: bool = True,
                locality_chunk: Optional[int] = None,
                cache_budget_bytes: Optional[int] = None,
                slow_lane_workers: Optional[int] = None,
                global_batch: Optional[int] = None) -> float:
        """Measure one cell; ``math.inf`` on overflow.

        ``record=False`` measures without logging a Trial (used for the
        paper's default-parameter reference run, which is not part of the
        sweep).  ``locality_chunk`` is the beyond-paper third axis,
        ``cache_budget_bytes`` the fourth, ``slow_lane_workers`` the
        fifth and ``global_batch`` (elastic geometry) the sixth; each is
        forwarded to the evaluator ONLY when set, so lower-dimensional
        searches keep working against evaluators that never heard of
        them.
        """
        nb = self.config.num_batches if num_batches is None else num_batches
        kw = {}
        if locality_chunk is not None:
            kw["locality_chunk"] = locality_chunk
        if cache_budget_bytes is not None:
            kw["cache_budget_bytes"] = cache_budget_bytes
        if slow_lane_workers is not None:
            kw["slow_lane_workers"] = slow_lane_workers
        if global_batch is not None:
            kw["global_batch"] = global_batch
        chunk = locality_chunk or 0
        budget = cache_budget_bytes or 0
        lanes = slow_lane_workers or 0
        gb = global_batch or 0
        try:
            stats = self.evaluator(nworker, nprefetch, num_batches=nb,
                                   epoch=self.config.epoch, **kw)
        except MemoryOverflow:
            if record:
                self.trials.append(Trial(nworker, nprefetch, math.inf,
                                         overflowed=True,
                                         locality_chunk=chunk,
                                         cache_budget_bytes=budget,
                                         slow_lane_workers=lanes,
                                         global_batch=gb))
            return math.inf
        if stats.overflowed:
            if record:
                self.trials.append(Trial(nworker, nprefetch, math.inf,
                                         overflowed=True,
                                         locality_chunk=chunk,
                                         cache_budget_bytes=budget,
                                         slow_lane_workers=lanes,
                                         global_batch=gb))
            return math.inf
        if record:
            self.trials.append(Trial(
                nworker, nprefetch, stats.seconds,
                peak_bytes=stats.peak_loader_bytes,
                batch_seconds=getattr(stats, "batch_seconds", None),
                locality_chunk=chunk,
                cache_budget_bytes=budget,
                slow_lane_workers=lanes,
                global_batch=gb))
        return stats.seconds

    def result(self, nworker: int, nprefetch: int, optimal_time: float,
               *, default_time: Optional[float] = None,
               locality_chunk: int = 0,
               cache_budget_bytes: int = 0,
               slow_lane_workers: int = 0,
               global_batch: int = 0) -> DPTResult:
        return DPTResult(nworker, nprefetch, optimal_time, self.trials,
                         default_time=default_time,
                         locality_chunk=locality_chunk,
                         cache_budget_bytes=cache_budget_bytes,
                         slow_lane_workers=slow_lane_workers,
                         global_batch=global_batch)


def worker_rungs(num_cpu_cores: int, num_devices: int) -> List[int]:
    """Algorithm 1's worker sweep: G, 2G, ... clamped to end exactly at N.

    The paper's ``while i < N: i += G`` overshoots when N is not divisible
    by G (it would measure more workers than the host has cores); the final
    rung is clamped to N instead.
    """
    rungs: List[int] = []
    i = 0
    while i < num_cpu_cores:
        i = min(i + num_devices, num_cpu_cores)
        rungs.append(i)
    return rungs


def adaptive_budget(config: DPTConfig,
                    explicit: Optional[int] = None) -> int:
    """Measurement budget per trial cell.

    With budget <= nWorker every config finishes in one parallel wave and
    all cells measure identically (pipeline fill, not steady-state rate),
    so the budget must comfortably exceed the largest worker count in the
    search space.  ``explicit`` (a user-set budget) wins; otherwise the
    budget is 3x the deepest worker rung, floored at 8.
    """
    if explicit is not None:
        return explicit
    n, g = config.resolve()
    rungs = worker_rungs(n, g)
    return max(8, 3 * (rungs[-1] if rungs else 1))


# one-sided Student-t critical values at alpha=0.05, indexed by df (1-based)
# through df=40, then stepped toward the normal tail — monotone, so the
# test never gets abruptly laxer as the sample count crosses a boundary
_T05 = [6.314, 2.920, 2.353, 2.132, 2.015, 1.943, 1.895, 1.860, 1.833,
        1.812, 1.796, 1.782, 1.771, 1.761, 1.753, 1.746, 1.740, 1.734,
        1.729, 1.725, 1.721, 1.717, 1.714, 1.711, 1.708, 1.706, 1.703,
        1.701, 1.699, 1.697, 1.696, 1.694, 1.692, 1.691, 1.690, 1.688,
        1.687, 1.686, 1.685, 1.684]


def t_critical(df: float) -> float:
    if df < 1:
        return _T05[0]
    if df < len(_T05):
        return _T05[int(df) - 1]
    # bracket lower-bound values: conservative and monotone past the table
    if df < 60:
        return 1.684
    if df < 120:
        return 1.671
    return 1.658


def steady_samples(samples: Optional[Sequence[float]]) -> List[float]:
    """Drop a measurement's pipeline-fill prefix (pool spin-up + first
    reads): the adaptive budget reserves ~1/3 of the batches for fill,
    and leaving it in inflates variance on both sides of a Welch test,
    gutting its power.  Shared by every win test that feeds welch_wins."""
    if not samples:
        return []
    return list(samples[len(samples) // 3:])


def welch_wins(current: Sequence[float], candidate: Sequence[float]) -> bool:
    """Variance-aware win test: is the candidate's mean per-batch time
    significantly lower than the current config's?

    Welch's unequal-variance t-test, one-sided at alpha=0.05 with the
    Welch-Satterthwaite degrees of freedom.  Replaces a fixed relative
    ``min_improvement`` threshold: a noisy host needs a bigger gap to call
    a winner, a quiet host can act on a smaller one.
    """
    na, nb = len(current), len(candidate)
    if na < 2 or nb < 2:
        return False
    ma = sum(current) / na
    mb = sum(candidate) / nb
    va = sum((x - ma) ** 2 for x in current) / (na - 1)
    vb = sum((x - mb) ** 2 for x in candidate) / (nb - 1)
    sa, sb = va / na, vb / nb
    if sa + sb <= 0.0:
        return mb < ma
    t = (ma - mb) / math.sqrt(sa + sb)
    df = (sa + sb) ** 2 / (sa ** 2 / (na - 1) + sb ** 2 / (nb - 1))
    return t >= t_critical(df)


@runtime_checkable
class TuningStrategy(Protocol):
    """A search policy over the (nWorker, nPrefetch) plane.

    Strategies are stateless: all measurement state lives in the
    TrialRecorder they are handed, so one strategy instance can serve many
    searches and strategies can be chained on a shared recorder (the
    warmstart+hillclimb combo does exactly that).
    """

    name: str

    def tune(self, recorder: TrialRecorder, **kwargs) -> DPTResult:
        ...


_REGISTRY: Dict[str, Type] = {}


def register_strategy(name: str):
    """Class decorator: ``@register_strategy("grid")``."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_strategy(name: str) -> TuningStrategy:
    _ensure_builtins()
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown tuning strategy {name!r}; "
            f"available: {available_strategies()}")
    return _REGISTRY[name]()


def available_strategies() -> List[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)


def _ensure_builtins() -> None:
    # strategies.py registers on import; lazy so base has no import cycle
    from repro_torch.tuning import strategies  # noqa: F401


def tune(*, evaluator: Evaluator,
         strategy: Union[str, TuningStrategy] = "grid",
         config: DPTConfig = DPTConfig(), **kwargs) -> DPTResult:
    """The single tuning front door.

    ``strategy`` is a registry name (``"grid"``, ``"successive_halving"``,
    ``"hillclimb"``, ``"warmstart_hillclimb"``, ``"goodput"``) or a
    TuningStrategy instance; strategy-specific knobs (``start=``,
    ``step_time_s=``, ...) pass through ``**kwargs``.  Every strategy
    honours the same MemoryOverflow semantics and returns a ``DPTResult``
    whose ``trials`` list the real measurements performed.
    """
    strat = get_strategy(strategy) if isinstance(strategy, str) else strategy
    recorder = TrialRecorder(evaluator, config)
    return strat.tune(recorder, **kwargs)
