"""Fault tolerance: heartbeats, straggler detection, failure-driven restart
and elastic re-mesh planning.

On a real fleet these hooks sit next to the coordinator (GCS / etcd); here
they are in-process with injectable clocks so the behaviour — detection
thresholds, restart decisions, re-mesh math — is testable deterministically.
The Trainer wires them in: per-step durations feed the StragglerDetector
(which can trigger a DPT re-tune on the slow host — the paper's knobs are
exactly what drifts when a host degrades), heartbeats feed the
HeartbeatRegistry, and a detected failure produces an ElasticPlan that maps
(surviving hosts, old mesh) -> (new mesh, resharded restore).
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple


class HeartbeatRegistry:
    def __init__(self, *, timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self._last: Dict[str, float] = {}

    def beat(self, host: str) -> None:
        self._last[host] = self.clock()

    def remove(self, host: str) -> None:
        """Forget a host (it was declared dead and resharded around, or it
        left gracefully) so it stops appearing in ``dead_hosts``."""
        self._last.pop(host, None)

    def hosts(self) -> List[str]:
        return sorted(self._last)

    def dead_hosts(self) -> List[str]:
        now = self.clock()
        return sorted(h for h, t in self._last.items()
                      if now - t > self.timeout_s)

    def alive_hosts(self) -> List[str]:
        dead = set(self.dead_hosts())
        return sorted(h for h in self._last if h not in dead)

    def state_dict(self) -> Dict[str, float]:
        """Last-beat ages (now - last), not absolute times: a restoring
        coordinator may run on a different clock origin."""
        now = self.clock()
        return {h: now - t for h, t in self._last.items()}

    def load_state(self, ages: Dict[str, float]) -> None:
        now = self.clock()
        self._last = {h: now - float(a) for h, a in ages.items()}

    def rearm(self, hosts: Sequence[str]) -> None:
        """Re-beat every host at NOW — used after failover so the outage
        window does not count against host liveness (a genuinely dead
        host simply times out once more)."""
        now = self.clock()
        for h in hosts:
            self._last[h] = now


class StragglerDetector:
    """Rolling-window per-host step times; a host is a straggler when its
    median exceeds ``threshold`` x the fleet median."""

    def __init__(self, *, window: int = 16, threshold: float = 1.5):
        self.window = window
        self.threshold = threshold
        self._times: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=self.window))

    def record(self, host: str, seconds: float) -> None:
        self._times[host].append(seconds)

    def forget(self, host: str) -> None:
        """Drop a departed host's window (its stale medians would otherwise
        skew the fleet median forever)."""
        self._times.pop(host, None)

    @staticmethod
    def _median(xs: Sequence[float]) -> float:
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def medians(self) -> Dict[str, float]:
        return {h: self._median(list(t)) for h, t in self._times.items() if t}

    def stragglers(self) -> List[str]:
        meds = self.medians()
        if len(meds) < 2:
            return []
        fleet = self._median(list(meds.values()))
        return sorted(h for h, m in meds.items()
                      if m > self.threshold * fleet)

    def state_dict(self) -> Dict[str, List[float]]:
        return {h: list(t) for h, t in self._times.items()}

    def load_state(self, windows: Dict[str, List[float]]) -> None:
        self._times.clear()
        for h, xs in windows.items():
            self._times[h].extend(float(x) for x in xs[-self.window:])


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Re-mesh decision after host loss."""
    old_hosts: int
    new_hosts: int
    new_data_axis: int               # devices along the data axis
    new_global_batch: int            # keep per-device batch constant
    restore_step: Optional[int]
    feasible: bool
    reason: str = ""


def plan_remesh(*, alive_hosts: int, devices_per_host: int, model_axis: int,
                old_hosts: int, old_global_batch: int,
                restore_step: Optional[int]) -> ElasticPlan:
    """Elastic scaling: keep the model axis intact (TP degree is dictated by
    memory), shrink the data axis to the surviving hosts, and scale the
    global batch to keep per-device batch constant (linear-scaling rule —
    the LR schedule is re-scaled by the Trainer accordingly).
    """
    total = alive_hosts * devices_per_host
    if total % model_axis:
        return ElasticPlan(old_hosts, alive_hosts, 0, 0, restore_step,
                           feasible=False,
                           reason=f"{total} devices not divisible by "
                                  f"model axis {model_axis}")
    new_data = total // model_axis
    old_data = old_hosts * devices_per_host // model_axis
    per_replica = old_global_batch / max(1, old_data)
    new_batch = int(round(per_replica * new_data))
    if new_batch == 0:
        return ElasticPlan(old_hosts, alive_hosts, new_data, 0, restore_step,
                           feasible=False, reason="batch would be 0")
    # The rounded batch can land on a value the sampler cannot shard
    # uniformly (ShardedSampler requires global_batch % host_count == 0
    # for a uniform split).  Snap to the nearest positive multiple of the
    # survivor count so the plan is always directly applicable, and leave
    # an audit trail of the adjustment.
    reason = ""
    if new_batch % alive_hosts:
        snapped = max(alive_hosts,
                      int(round(new_batch / alive_hosts)) * alive_hosts)
        reason = (f"snapped global batch {new_batch} -> {snapped} "
                  f"(nearest multiple of {alive_hosts} hosts)")
        new_batch = snapped
    return ElasticPlan(old_hosts, alive_hosts, new_data, new_batch,
                       restore_step, feasible=True, reason=reason)


class FailureInjector:
    """Deterministic failure schedule for tests/examples:
    ``{step: [host, ...]}`` marks hosts dead at a given step."""

    def __init__(self, schedule: Dict[int, Sequence[str]]):
        self.schedule = dict(schedule)
        self.dead: Set[str] = set()

    def advance(self, step: int) -> List[str]:
        newly = list(self.schedule.get(step, []))
        self.dead.update(newly)
        return newly
