"""Trainer: the end-to-end loop that makes DPT a first-class framework
feature rather than an offline script, as ported to PyTorch.

Startup:  restore latest checkpoint (step + sampler offset + loader params)
          -> DPT-tune the loader (or reuse the cached result for this
          machine/dataset fingerprint) -> build the train step.
Steady:   device-prefetched batches -> train step; per-step wall time
          (up to the end of the step's device work) feeds the
          StragglerDetector; every ``checkpoint_every`` steps an async
          checkpoint (params, opt state, sampler state, loader params) in
          ``repro``'s on-disk layout.
Drift:    an OnlineTuner (repro_torch.tuning.online) watches the per-step
          data-wait vs compute-time goodput signal; when the loader
          becomes the bottleneck it runs a bounded re-search and
          hot-swaps the winner into the live stream (no rebuild, no lost
          batches).

The model is given as its ``ModelConfig``.  Each Trainer draws its own
train state from it with a ``torch.Generator`` seeded with
``TrainerConfig.seed`` on the Trainer's device (the card unless
``device="cpu"``): a port model holds its fp32 masters and the step
updates them in place, so no two Trainers may share one, and a restart
must never start from the crashed run's weights.  ``connect_fleet``
attaches the Trainer to a fleet (a transport-attached HostAgent of
``repro_torch.tuning.fleet``): the coordinator's reshards and pushed
params then reach its live stream.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.core.cache import DPTCache
from repro_torch.core.dpt import DPTConfig
from repro_torch.core.evaluators import LoaderEvaluator
from repro_torch.data.loader import DataLoader, LoaderParams
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.train.train_step import (TrainState, TrainStepConfig,
                                          init_train_state, make_train_step)
from repro_torch.tuning import (OnlineTuner, OnlineTunerConfig,
                                adaptive_budget, tune)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.fingerprint import machine_fingerprint


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    seed: int = 0
    # DPT integration (startup tune + online retune, see repro_torch.tuning)
    autotune: bool = True
    autotune_strategy: str = "grid"
    # None derives the per-cell budget adaptively (>= 3x the deepest
    # worker rung — see tuning.base.adaptive_budget)
    autotune_budget_batches: Optional[int] = None
    autotune_max_prefetch: int = 4
    # CPU cores the startup grid and the online re-search may give the
    # loader (DPTConfig / OnlineTunerConfig ``num_cpu_cores``); None is
    # every core of the host.  Not in ``repro``'s TrainerConfig.
    autotune_num_cpu_cores: Optional[int] = None
    # candidate sampler locality_chunk values for the startup grid
    # (DESIGN.md §5).  None keeps the search on the paper's two axes;
    # include 0 in the tuple so fully-random order stays a candidate —
    # warm/CPU-bound profiles should be free to reject chunking.
    # Single-host only: on a sharded fleet the axis is ignored (every host
    # must slice the SAME epoch permutation, so locality can only change
    # uniformly via the coordinator, never from a per-host tune).
    autotune_locality_chunks: Optional[tuple] = None
    # candidate cache_budget_bytes values for the startup grid's fourth
    # axis (DESIGN.md §7).  None keeps the cache tier off the search;
    # include 0 in the tuple so "no cache" stays a candidate.  Single-host
    # startup only, same as locality: on a fleet the budget changes
    # uniformly through the coordinator (FleetConfig.cache_budgets).
    autotune_cache_budgets: Optional[tuple] = None
    # candidate slow_lane_workers values for the startup grid's fifth
    # axis (DESIGN.md §9).  None keeps the dual lane off the search;
    # include 0 in the tuple so "no slow lane" stays a candidate.  The
    # lane is HOST-LOCAL machinery (it never touches the sampler's epoch
    # permutation, only which worker decodes a batch), so unlike locality
    # and cache this axis needs no multi-host guard — only the
    # grid-strategy guard applies.
    autotune_slow_lanes: Optional[tuple] = None
    # retune trigger on the per-item cost tail ratio (p99/median of the
    # loader's tracked per-item costs, ~1 uniform; see DESIGN.md §9).
    # 0 disables; only armed when autotune_slow_lanes is set.
    retune_tail_ratio_trigger: float = 0.0
    # retune trigger on the loader's windowed fault rate (DESIGN.md §10):
    # fires a re-search when the storage browns out and once more when
    # degraded mode heals.  0 disables.
    retune_fault_rate_trigger: float = 0.0
    # the online locality loop (DESIGN.md §6): when True, an
    # AdaptiveLocalityController watches the live coalesced-run-length
    # counters and shrinks locality_chunk when the storage stops
    # achieving it (cache warmed, topology changed) — no search, applied
    # as an epoch-latched hot swap.  On a fleet the proposal routes to
    # the coordinator instead (locality must change uniformly).  The
    # single-host OnlineTuner also sweeps autotune_locality_chunks at
    # retune time, so the knob can climb back UP when storage slows.
    adaptive_locality: bool = False
    retune_stall_fraction: float = 0.5   # data-wait/compute drift trigger
    retune_window: int = 8
    retune_cooldown_steps: int = 16
    dpt_cache_path: Optional[str] = None
    # zero-copy slab-arena delivery (DESIGN.md §3).  Default ON: the train
    # loop consumes device batches through the prefetcher (which transfers
    # before the slab recycles) and never retains a host view, so the
    # batch-lifetime contract holds.  Silently inert for datasets without
    # the fast path or for process pools.
    zero_copy: bool = True
    # linear-scaling rule (DESIGN.md §11): when the elastic geometry latch
    # changes the loader's global batch mid-run (a fleet reshard scaled
    # the fleet), scale the LR schedule by new/old and rebuild the step.
    # plan_remesh promises exactly this hand-off ("the LR schedule is
    # re-scaled by the Trainer accordingly").
    lr_linear_scaling: bool = True
    step_config: TrainStepConfig = dataclasses.field(
        default_factory=TrainStepConfig)


class Trainer:
    def __init__(self, model: ModelConfig, loader: DataLoader,
                 cfg: TrainerConfig, *, host_name: str = "host0",
                 agent=None, device="cuda"):
        if not isinstance(model, ModelConfig):
            raise TypeError("Trainer takes the model's ModelConfig and "
                            "draws its own train state from it")
        self.model_config = model
        self.loader = loader
        self.cfg = cfg
        self.host_name = host_name
        self.device = resolve_device(device)
        if loader.device.type != self.device.type:
            raise ValueError(f"the loader delivers to {loader.device}, the "
                             f"trainer runs on {self.device}")
        # fleet mode: an agent whose ``observe`` takes the goodput signal
        # and whose ``notify_locality`` takes locality proposals (a
        # ``tuning.fleet.HostAgent``, which ``connect_fleet`` builds); the
        # local OnlineTuner stays off.
        self.agent = agent
        self.checkpointer = Checkpointer(cfg.checkpoint_dir) \
            if cfg.checkpoint_dir else None
        self.straggler = StragglerDetector()
        # built over the state's model once the state exists
        self.step_fn = None
        self.state: Optional[TrainState] = None
        self.start_step = 0
        # reference batch for the linear-scaling LR hook: the geometry the
        # current step_fn's schedule was built for
        self._lr_batch = loader.global_batch
        self.online_tuner: Optional[OnlineTuner] = None
        self.locality_controller = None
        self.history: List[Dict[str, Any]] = []
        # the latest tune_loader: wall seconds and trial cells measured
        # (0 when the DPT cache answered)
        self.tune_s: Optional[float] = None
        self.tune_trials: Optional[int] = None

    def connect_fleet(self, transport, *, join: bool = False,
                      coord: str = "coord", link_config=None,
                      clock=time.monotonic):
        """Attach this trainer to a fleet over a message transport.

        Builds a transport-attached HostAgent around ``self.loader`` and
        registers (or ``join=True`` mid-run admits) it with the
        coordinator endpoint.  After this, ``run()`` streams observations
        over the wire and the coordinator's pushes (params, reshards,
        schedules) arrive as fenced commands — and a coordinator outage
        never blocks the step loop: the host trains on its last
        latched params and re-syncs on reconnect."""
        from repro_torch.tuning.fleet import connect_host
        self.agent = connect_host(
            transport, self.host_name, self.loader, coord=coord,
            link_config=link_config, clock=clock, join=join)
        return self.agent

    # ---- DPT integration ----------------------------------------------------
    def tune_loader(self, *, force: bool = False) -> LoaderParams:
        """Startup tune through the unified ``tune(...)`` front door (or
        reuse the cached result for this machine/dataset fingerprint)."""
        t0 = time.perf_counter()
        cache = DPTCache(self.cfg.dpt_cache_path)
        mfp = machine_fingerprint()
        dfp = self.loader.dataset.fingerprint()
        strategy = self.cfg.autotune_strategy
        locality_axis = self.cfg.autotune_locality_chunks
        if locality_axis and self.loader.sampler.host_count > 1:
            # per-host tuned chunks would give each host a DIFFERENT epoch
            # permutation, breaking the cross-host coverage invariant the
            # fleet relies on (every host must slice the SAME perm).  A
            # multi-host locality change must arrive uniformly through the
            # coordinator, not the local startup tune.
            locality_axis = None
        if locality_axis and strategy != "grid":
            # only the grid strategy sweeps DPTConfig.locality_chunks; for
            # any other strategy the axis is unsearched and the result's
            # locality_chunk=0 must not be force-applied over the user's
            locality_axis = None
        cache_axis = self.cfg.autotune_cache_budgets
        if cache_axis and (self.loader.sampler.host_count > 1
                           or strategy != "grid"):
            # same guards as locality: the cache plan shapes the epoch
            # permutation (interleaved hot chunks), so a sharded fleet
            # changes the budget uniformly via the coordinator; and only
            # the grid strategy sweeps the axis
            cache_axis = None
        lane_axis = self.cfg.autotune_slow_lanes
        if lane_axis and strategy != "grid":
            # only the grid strategy sweeps DPTConfig.slow_lanes.  No
            # multi-host guard: the lane split is host-local (it never
            # touches the shared epoch permutation)
            lane_axis = None
        cached = None if force else cache.get_params(
            mfp, dfp, self.loader.global_batch,
            require_locality=bool(locality_axis),
            require_cache=bool(cache_axis),
            with_cache=bool(cache_axis),
            require_slow_lane=bool(lane_axis),
            with_slow_lane=bool(lane_axis))
        if cached is not None:
            rep = {"num_workers": cached[0], "prefetch_factor": cached[1]}
            if locality_axis:
                # only adopt a cached locality when this run searches the
                # axis — a 2-axis run must not silently reset a user-set
                # locality_chunk to a stale cached value
                rep["locality_chunk"] = cached[2]
            if cache_axis:
                rep["cache_budget_bytes"] = cached[3]
            if lane_axis:
                # the lane width is the LAST element whenever requested
                rep["slow_lane_workers"] = cached[-1]
            params = self.loader.params.replace(**rep)
            self.loader.with_params(params)
            self.tune_s, self.tune_trials = time.perf_counter() - t0, 0
            return params
        ev = LoaderEvaluator(self.loader, to_device=True)
        search_cfg = DPTConfig(max_prefetch=self.cfg.autotune_max_prefetch,
                               num_cpu_cores=self.cfg.autotune_num_cpu_cores,
                               locality_chunks=(tuple(locality_axis)
                                                if locality_axis else None),
                               cache_budgets=(tuple(cache_axis)
                                              if cache_axis else None),
                               slow_lanes=(tuple(lane_axis)
                                           if lane_axis else None))
        search_cfg = dataclasses.replace(search_cfg, num_batches=(
            adaptive_budget(search_cfg, self.cfg.autotune_budget_batches)))
        if strategy == "grid":
            kwargs = {"measure_default": False}
        elif strategy == "successive_halving":
            kwargs = {}
        elif strategy == "hillclimb":
            _, G = search_cfg.resolve()
            kwargs = {"start": (max(G, self.loader.params.num_workers),
                                self.loader.params.prefetch_factor)}
        else:
            # goodput needs a measured step time, warmstart needs profiles —
            # neither exists before the first step
            raise ValueError(
                f"autotune_strategy {strategy!r} cannot run at startup; "
                "use 'grid', 'successive_halving' or 'hillclimb'")
        result = tune(evaluator=ev, strategy=strategy,
                      config=search_cfg, **kwargs)
        cache.put(mfp, dfp, self.loader.global_batch, result)
        rep = {"num_workers": result.nworker,
               "prefetch_factor": result.nprefetch}
        if locality_axis:
            rep["locality_chunk"] = result.locality_chunk
        if cache_axis:
            rep["cache_budget_bytes"] = result.cache_budget_bytes
        if lane_axis:
            rep["slow_lane_workers"] = result.slow_lane_workers
        params = self.loader.params.replace(**rep)
        self.loader.with_params(params)
        self.tune_s = time.perf_counter() - t0
        self.tune_trials = len(result.trials)
        return params

    def _make_online_tuner(self) -> OnlineTuner:
        # the online locality axis follows the startup grid's candidate
        # set; single-host only (fleet mode never builds a local tuner,
        # and a sharded loader must change locality via the coordinator)
        chunks = self.cfg.autotune_locality_chunks \
            if self.loader.sampler.host_count == 1 else None
        budgets = self.cfg.autotune_cache_budgets \
            if self.loader.sampler.host_count == 1 else None
        # the lane axis is host-local, so it needs no host_count guard
        lanes = self.cfg.autotune_slow_lanes
        return OnlineTuner(
            self.loader,
            evaluator=LoaderEvaluator(self.loader, to_device=True),
            cache=DPTCache(self.cfg.dpt_cache_path),
            config=OnlineTunerConfig(
                stall_fraction=self.cfg.retune_stall_fraction,
                window=self.cfg.retune_window,
                cooldown_steps=self.cfg.retune_cooldown_steps,
                retune_budget_batches=self.cfg.autotune_budget_batches,
                max_prefetch=self.cfg.autotune_max_prefetch,
                num_cpu_cores=self.cfg.autotune_num_cpu_cores,
                locality_chunks=(tuple(chunks) if chunks else None),
                cache_budgets=(tuple(budgets) if budgets else None),
                slow_lanes=(tuple(lanes) if lanes else None),
                tail_ratio_trigger=self.cfg.retune_tail_ratio_trigger,
                fault_rate_trigger=self.cfg.retune_fault_rate_trigger))

    def _make_locality_controller(self):
        """The counter-driven side of the online locality loop: applies
        locally on a single host; on a fleet, a proposal only *signals*
        the coordinator (locality must change uniformly there).  A
        sharded loader WITHOUT an agent gets no controller at all — a
        local resize would hand this host a different epoch permutation
        than its peers (same guard as the startup tune's locality axis).
        """
        from repro_torch.tuning import AdaptiveLocalityController
        if self.agent is None and self.loader.sampler.host_count > 1:
            return None
        on_propose = None
        if self.agent is not None:
            # the coordinator drops the request when the fleet searches
            # no locality axis (a search that can't touch the knob would
            # burn goodput on every repeated proposal)
            on_propose = self.agent.notify_locality
        return AdaptiveLocalityController(self.loader,
                                          on_propose=on_propose)

    # ---- checkpoint/restart ---------------------------------------------------
    def _init_state(self) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        return init_train_state(self.model_config, gen, self.cfg.step_config,
                                device=self.device)

    def _maybe_restore(self) -> None:
        self.state = self.step_fn = None     # never two states at once
        if self.checkpointer is None or self.checkpointer.latest_step() is None:
            self.state = self._init_state()
        else:
            self.state, aux = self.checkpointer.restore(self._init_state())
            self.start_step = int(aux["step"])
            if "loader" in aux:
                self.loader.load_state_dict(aux["loader"])
        self.step_fn = make_train_step(self.state.model,
                                       self.cfg.step_config)

    def _consumed_state(self, step: int):
        """Sampler state reflecting batches the TRAINER consumed (one per
        step) — the producer runs ahead by worker queues + device prefetch,
        so loader.sampler.state would skip batches on restart.  Walks the
        geometry schedule (batches-per-epoch can differ per epoch after an
        elastic latch), not a fixed bpe."""
        s = self.loader.sampler
        base = s.epoch_start(self._stream_base.epoch) \
            + self._stream_base.batch_offset
        return s.state_at(base + (step - self._stream_base_step))

    def _rebuild_stream(self, step: int):
        """(Re)create the batch iterator from the consumed position."""
        self.loader.sampler.state = self._consumed_state(step) \
            if hasattr(self, "_stream_base") else self.loader.sampler.state
        self._stream_base = copy.deepcopy(self.loader.sampler.state)
        self._stream_base_step = step
        return iter(self.loader)

    def _save(self, step: int, block: bool = False) -> None:
        if self.checkpointer is None:
            return
        sd = self.loader.state_dict()
        sd["sampler"] = self._consumed_state(step).to_dict()
        self.checkpointer.save(step, self.state, aux={"loader": sd},
                               block=block)

    def _maybe_rescale_lr(self) -> None:
        """Linear-scaling rule: when the global batch moved (an elastic
        geometry latch crossed an epoch boundary), scale peak_lr by
        new/old and rebuild the step."""
        gb = self.loader.global_batch
        if not self.cfg.lr_linear_scaling or gb == self._lr_batch:
            return
        scale = gb / self._lr_batch
        opt = self.cfg.step_config.optimizer
        self.cfg.step_config = dataclasses.replace(
            self.cfg.step_config,
            optimizer=dataclasses.replace(opt, peak_lr=opt.peak_lr * scale))
        self.step_fn = make_train_step(self.state.model,
                                       self.cfg.step_config)
        self.history.append({"event": "lr_rescale", "scale": scale,
                             "global_batch": gb,
                             "peak_lr": self.cfg.step_config.optimizer.peak_lr})
        self._lr_batch = gb

    def _apply_delivery_defaults(self) -> None:
        """Flip zero-copy delivery on when the pipeline supports it — the
        trainer's consumption pattern (device batches via the prefetcher,
        nothing retained host-side) satisfies the batch-lifetime contract
        unconditionally."""
        p = self.loader.params
        if (self.cfg.zero_copy and not p.zero_copy and p.fast_path
                and not p.use_processes
                and self.loader.dataset.supports_fast_path):
            self.loader.with_params(p.replace(zero_copy=True))

    # ---- main loop -----------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        self._maybe_restore()
        self._apply_delivery_defaults()
        if cfg.autotune:
            self.tune_loader()
            if self.agent is None:
                self.online_tuner = self._make_online_tuner()
        if cfg.adaptive_locality:
            self.locality_controller = self._make_locality_controller()

        step = self.start_step
        batches = self._rebuild_stream(step)
        t_wall = time.perf_counter()
        last_metrics: Dict[str, Any] = {}
        try:
            while step < cfg.total_steps:
                self._maybe_rescale_lr()
                t0 = time.perf_counter()
                try:
                    batch = next(batches)
                except StopIteration:
                    batches = self._rebuild_stream(step)
                    batch = next(batches)
                t_data = time.perf_counter() - t0
                self.state, metrics = self.step_fn(self.state, batch)
                # reading the loss waits for the step's device work, so the
                # step's clock (and the goodput signal) holds it
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                self.straggler.record(self.host_name, dt)
                step += 1

                # loader-drift retune (paper §5: cloud environments drift).
                # A triggered retune hot-swaps the live stream in place — no
                # rebuild, no lost batches, sampler position preserved.  In
                # fleet mode the same signal goes to the agent instead.
                if self.agent is not None:
                    self.agent.observe(data_s=t_data, step_s=dt)
                elif self.online_tuner is not None:
                    self.online_tuner.observe(data_s=t_data, step_s=dt)
                if self.locality_controller is not None:
                    self.locality_controller.step()

                if step % cfg.log_every == 0 or step == cfg.total_steps:
                    rec = {"step": step,
                           "loss": loss,
                           "grad_norm": float(metrics["grad_norm"]),
                           "lr": float(metrics["lr"]),
                           "step_s": dt, "data_s": t_data}
                    self.history.append(rec)
                    last_metrics = rec
                if self.checkpointer and step % cfg.checkpoint_every == 0:
                    self._save(step)
        finally:
            # the stream's worker threads and device buffers end with the
            # run
            batches.close()
        self._save(cfg.total_steps, block=True)
        wall = time.perf_counter() - t_wall
        return {"final_step": step, "wall_s": wall, **last_metrics}
