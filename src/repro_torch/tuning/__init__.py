"""repro_torch.tuning — the unified tuning layer, as ported to PyTorch.

``tune(evaluator=..., strategy=..., config=...)`` is the single front door
to every search policy (see ``base.py``).  Strategy implementations live in
``strategies.py`` and self-register; third-party strategies register the
same way::

    from repro_torch.tuning import register_strategy

    @register_strategy("my_policy")
    class MyPolicy:
        def tune(self, recorder, **kwargs): ...

``repro``'s online tuner, locality sweeps, transport and fleet control
plane (``online``, ``locality``, ``transport``, ``fleet``) are not ported
yet.
"""
from repro_torch.tuning.base import (  # noqa: F401
    TrialRecorder,
    TuningStrategy,
    adaptive_budget,
    available_strategies,
    get_strategy,
    register_strategy,
    tune,
    welch_wins,
    worker_rungs,
)
from repro_torch.tuning.strategies import (  # noqa: F401
    CostModelPrediction,
    GoodputTune,
    GridSearch,
    HillClimb,
    SuccessiveHalving,
    WarmstartHillClimb,
    cost_model_warmstart,
)
