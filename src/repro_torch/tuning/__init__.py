"""repro_torch.tuning — the unified tuning layer, as ported to PyTorch.

``tune(evaluator=..., strategy=..., config=...)`` is the single front door
to every search policy (see ``base.py``); ``OnlineTuner`` turns tuning into
a continuous background activity against a live, hot-swappable DataLoader
(``online.py``: split into observe/decide/act components), and
``locality.py`` holds the online locality, cache and slow-lane sweeps and
the counter-driven ``AdaptiveLocalityController``; the fleet control plane
(``fleet.py``: HostAgent + FleetCoordinator, over ``transport.py``)
recomposes those components across hosts — coordinated re-consensus and
elastic resharding.  Strategy implementations live in ``strategies.py``
and self-register; third-party strategies register the same way::

    from repro_torch.tuning import register_strategy

    @register_strategy("my_policy")
    class MyPolicy:
        def tune(self, recorder, **kwargs): ...
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
from repro_torch.tuning.locality import (  # noqa: F401
    AdaptiveLocalityConfig,
    AdaptiveLocalityController,
    cache_win,
    locality_win,
    slow_lane_win,
    sweep_cache,
    sweep_locality,
    sweep_slow_lanes,
)
from repro_torch.tuning.online import (  # noqa: F401
    GoodputMonitor,
    OnlineTuner,
    OnlineTunerConfig,
    RetuneExecutor,
    RetunePolicy,
)
from repro_torch.tuning.transport import (  # noqa: F401
    AgentLink,
    FaultSpec,
    FaultyTransport,
    LeaderLease,
    LinkConfig,
    LocalTransport,
    SnapshotStore,
    StaleLeaderError,
    Transport,
    TransportError,
)
from repro_torch.tuning.fleet import (  # noqa: F401
    CoordinatorReplica,
    CoordinatorServer,
    FleetConfig,
    FleetCoordinator,
    HostAgent,
    HostReport,
    RemoteAgent,
    connect_host,
    uniform_consensus,
)
