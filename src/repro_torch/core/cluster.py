"""Fleet simulation for MultiHostDPT and the fleet control plane:
heterogeneous hosts (stragglers, degraded storage, fewer free cores) built
from perturbed machine/storage profiles, plus deterministic join/leave/
degrade schedules that drive elastic-fleet scenarios.  Used by
benchmarks/bench_multihost.py, benchmarks/bench_fleet.py and the FT tests.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from repro_torch.core.evaluators import SimulatorEvaluator
from repro_torch.core.simulator import LoaderSimulator, MachineProfile
from repro_torch.data.storage import StorageProfile


@dataclasses.dataclass(frozen=True)
class HostSpec:
    name: str
    machine: MachineProfile
    storage: StorageProfile


def degraded(machine: MachineProfile, *, cpu_scale: float = 1.0,
             io_scale: float = 1.0, ram_scale: float = 1.0) -> MachineProfile:
    return dataclasses.replace(
        machine,
        physical_cores=max(1, int(machine.physical_cores * cpu_scale)),
        logical_cores=max(1, int(machine.logical_cores * cpu_scale)),
        host_ram=machine.host_ram * ram_scale,
    )


def degraded_storage(storage: StorageProfile, *,
                     bw_scale: float = 1.0,
                     latency_scale: float = 1.0) -> StorageProfile:
    return dataclasses.replace(
        storage,
        storage_bw=storage.storage_bw * bw_scale,
        io_latency_s=storage.io_latency_s * latency_scale,
    )


def make_fleet(base_machine: MachineProfile, base_storage: StorageProfile,
               *, num_hosts: int, slow_hosts: Sequence[int] = (),
               slow_cpu_scale: float = 0.5,
               slow_io_scale: float = 0.3) -> List[HostSpec]:
    """num_hosts homogeneous hosts with ``slow_hosts`` degraded (the
    straggler-injection scenario)."""
    fleet = []
    for h in range(num_hosts):
        if h in slow_hosts:
            m = degraded(base_machine, cpu_scale=slow_cpu_scale)
            s = degraded_storage(base_storage, bw_scale=slow_io_scale,
                                 latency_scale=1.0 / slow_io_scale)
        else:
            m, s = base_machine, base_storage
        fleet.append(HostSpec(f"host{h}", m, s))
    return fleet


def fleet_evaluators(fleet: Sequence[HostSpec], *, batch_size: int,
                     device_ram: Optional[float] = None
                     ) -> List[SimulatorEvaluator]:
    return [SimulatorEvaluator(LoaderSimulator(h.storage, h.machine),
                               batch_size=batch_size, device_ram=device_ram)
            for h in fleet]


# --------------------------------------------------------------------------
# elastic-fleet scenario schedules (join / leave / degrade at a step)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FleetEvent:
    """One scheduled perturbation of the running fleet.

    ``kind`` is ``"leave"`` (the host goes silent: heartbeat timeout ->
    coordinator reshards around it), ``"join"`` (a new host enters at the
    barrier) or ``"degrade"`` (the host's CPU/IO capacity is scaled —
    what the straggler detector and re-consensus react to).

    Control-plane faults (transport-mode fleets, DESIGN.md §8):
    ``"partition"`` cuts the host's link to the coordinator (the host
    keeps streaming on latched params), ``"heal"`` restores it, and
    ``"coord_crash"`` kills the coordinator itself (``host`` names the
    coordinator endpoint; a standby's lease-driven promotion recovers) —
    these drive the FaultyTransport, not the host processes.
    """
    step: int
    kind: str        # "leave"|"join"|"degrade"|"partition"|"heal"|"coord_crash"
    host: str
    cpu_scale: float = 1.0            # degrade only
    io_scale: float = 1.0             # degrade only

    def __post_init__(self):
        if self.kind not in ("leave", "join", "degrade",
                             "partition", "heal", "coord_crash"):
            raise ValueError(f"unknown fleet event kind {self.kind!r}")


class FleetSchedule:
    """Deterministic event timeline for elastic-fleet runs.

    The driver calls ``at(step)`` once per lockstep round and applies the
    returned events (kill the host's driver loop, construct + ``join`` a
    new agent, degrade the host's storage profile).  Mirrors
    ``FailureInjector`` but speaks the full join/leave/degrade vocabulary
    the control plane handles.
    """

    def __init__(self, events: Sequence[FleetEvent] = ()):
        self._by_step: Dict[int, List[FleetEvent]] = defaultdict(list)
        for e in events:
            self._by_step[e.step].append(e)
        self.fired: List[FleetEvent] = []

    def add(self, event: FleetEvent) -> "FleetSchedule":
        self._by_step[event.step].append(event)
        return self

    def at(self, step: int) -> List[FleetEvent]:
        events = self._by_step.pop(step, [])
        self.fired.extend(events)
        return events

    @property
    def pending(self) -> int:
        return sum(len(v) for v in self._by_step.values())
