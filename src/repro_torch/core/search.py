"""Beyond-paper search strategies — compatibility shims, the counterpart
of ``repro/core/search.py``.

The implementations live in the unified strategy layer in
``repro_torch.tuning`` (one ``TuningStrategy`` protocol + registry, shared
Trial bookkeeping and MemoryOverflow semantics); these functions keep the
original signatures and delegate:

* ``successive_halving``   -> ``tune(strategy="successive_halving", ...)``
* ``coordinate_hillclimb`` -> ``tune(strategy="hillclimb", ...)``
* ``tuned_with_warmstart`` -> ``tune(strategy="warmstart_hillclimb", ...)``
* ``goodput_tune``         -> ``tune(strategy="goodput", ...)``
* ``cost_model_warmstart`` — zero-measurement analytic seed (re-exported
  from ``repro_torch.tuning.strategies``).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.core.dpt import DPTConfig, DPTResult
from repro_torch.core.simulator import MachineProfile
from repro_torch.data.storage import StorageProfile
from repro_torch.tuning.base import tune
from repro_torch.tuning.strategies import (  # noqa: F401  (compat re-exports)
    CostModelPrediction,
    cost_model_warmstart,
)


def successive_halving(evaluator, *, config: DPTConfig = DPTConfig(),
                       eta: int = 3, min_batches: int = 4) -> DPTResult:
    return tune(evaluator=evaluator, strategy="successive_halving",
                config=config, eta=eta, min_batches=min_batches)


def coordinate_hillclimb(evaluator, *, start: Tuple[int, int],
                         config: DPTConfig = DPTConfig(),
                         max_steps: int = 24) -> DPTResult:
    return tune(evaluator=evaluator, strategy="hillclimb", config=config,
                start=start, max_steps=max_steps)


def tuned_with_warmstart(evaluator, storage: StorageProfile,
                         machine: MachineProfile, *, batch_size: int,
                         config: DPTConfig = DPTConfig()) -> DPTResult:
    return tune(evaluator=evaluator, strategy="warmstart_hillclimb",
                config=config, storage=storage, machine=machine,
                batch_size=batch_size)


def goodput_tune(evaluator, *, step_time_s: float, num_batches: int,
                 config: DPTConfig = DPTConfig(),
                 margin: float = 0.1) -> DPTResult:
    return tune(evaluator=evaluator, strategy="goodput", config=config,
                step_time_s=step_time_s, num_batches=num_batches,
                margin=margin)
