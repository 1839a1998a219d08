"""Batched serving engine: prefill plus a decode loop over a KV cache the
engine owns and updates in place, and a request-batching frontend.

The PyTorch counterpart of ``repro/serve/engine.py``.  Every entry point
runs on ``cuda`` unless the caller passes ``device="cpu"``; without a card
and without that request it raises rather than run on the CPU.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.data.costs import KeyedCostTracker, percentile
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray           # (B, <=max_new_tokens) generated ids
    prefill_s: float
    decode_s: float
    steps: int

    @property
    def tokens_per_second(self) -> float:
        n = self.tokens.shape[0] * self.steps
        return n / self.decode_s if self.decode_s > 0 else 0.0


class ServeEngine:
    """Runs ``model`` (a ``DecoderLM`` or ``EncDecLM`` holding its
    parameters) on ``device``, moving the model there if it is
    elsewhere."""

    def __init__(self, model, *, max_batch: int, max_len: int,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            model = model.to(self.device)
            model.device = self.device
        self.model = model
        self.max_batch = max_batch
        self.max_len = max_len
        self.temperature = temperature
        self.eos_id = eos_id

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits, gen: torch.Generator):
        logits = logits[:, -1, :].float()
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 *, seed: int = 0, extra_inputs: Optional[dict] = None
                 ) -> GenerateResult:
        """prompts: (B, S) integer ids, all of one length.
        ``extra_inputs``: more fields of the prefill batch, each moved to
        the engine's device as it is (a vlm's ``patch_embeds`` (B, P,
        patch_embed_dim), whisper's ``frames`` (B, max_source_positions,
        d_model)); the cache holds ``max_len`` text positions past
        the model's prefix."""
        B, S = prompts.shape
        if B > self.max_batch or S + max_new_tokens > self.max_len:
            raise ValueError(f"batch {B} x ({S} + {max_new_tokens}) exceeds "
                             f"max_batch {self.max_batch} / max_len "
                             f"{self.max_len}")
        cache = self.model.init_cache(B, self.max_len)
        batch = {"tokens": torch.as_tensor(np.asarray(prompts),
                                           dtype=torch.long,
                                           device=self.device)}
        for k, v in (extra_inputs or {}).items():
            batch[k] = torch.as_tensor(v, device=self.device)

        t0 = time.perf_counter()
        logits, cache = self.model.prefill(batch, cache)
        self._sync()
        t_prefill = time.perf_counter() - t0

        gen = torch.Generator(device=self.device).manual_seed(seed)
        tok = self._sample(logits, gen)
        out = [tok]
        positions = torch.full((B,), S, dtype=torch.long, device=self.device)
        done = np.zeros(B, bool)

        t1 = time.perf_counter()
        steps = 0
        for _ in range(max_new_tokens - 1):
            logits, cache = self.model.decode_step(cache, tok[:, None],
                                                   positions)
            tok = self._sample(logits, gen)
            positions = positions + 1
            steps += 1
            out.append(tok)
            if self.eos_id is not None:
                done |= tok.cpu().numpy() == self.eos_id
                if done.all():
                    break
        self._sync()
        t_decode = time.perf_counter() - t1
        tokens_out = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        return GenerateResult(tokens_out, t_prefill, t_decode, steps + 1)


@dataclasses.dataclass
class Request:
    prompt: np.ndarray
    max_new_tokens: int
    result: "queue.Queue" = dataclasses.field(
        default_factory=lambda: queue.Queue(maxsize=1))
    # submission wall time (set by BatchingFrontend.submit): the batch
    # assembly wait, submit to generate-start, is measured from this
    t_submit: float = 0.0


class BatchMixMonitor:
    """Detects drift in the mix of served batch shapes and fires a retune.

    The frontend records one shape key per batch served; when the bucketed
    distribution over the last ``window`` batches diverges from the
    previous window by more than ``threshold`` (half the L1 distance, in
    [0, 1]), ``on_drift`` fires with the new mix distribution.  Callback
    errors are contained by the serving thread (reported to stderr).
    """

    def __init__(self, *, window: int = 32, threshold: float = 0.35,
                 cooldown: int = 64, on_drift=None):
        self.window = window
        self.threshold = threshold
        self.cooldown = cooldown
        self.on_drift = on_drift
        self._recent: List = []
        self._baseline: Optional[dict] = None
        self._since_fire = 0
        self.drifts = 0

    @staticmethod
    def _dist(keys) -> dict:
        d: dict = {}
        for k in keys:
            d[k] = d.get(k, 0) + 1
        n = max(1, len(keys))
        return {k: v / n for k, v in d.items()}

    @staticmethod
    def divergence(a: dict, b: dict) -> float:
        """Half the L1 distance between two mix distributions (0..1)."""
        keys = set(a) | set(b)
        return 0.5 * sum(abs(a.get(k, 0.0) - b.get(k, 0.0)) for k in keys)

    def record(self, shape_key) -> bool:
        """One call per batch served; returns True when drift fired."""
        self._recent.append(shape_key)
        self._since_fire += 1
        if len(self._recent) < self.window:
            return False
        current = self._dist(self._recent[-self.window:])
        if self._baseline is None:
            self._baseline = current
            self._recent = self._recent[-self.window:]
            return False
        self._recent = self._recent[-self.window:]
        if self._since_fire < self.cooldown:
            return False
        if self.divergence(self._baseline, current) <= self.threshold:
            return False
        self._baseline = current
        self._since_fire = 0
        self.drifts += 1
        if self.on_drift is not None:
            self.on_drift(current)
        return True


class BatchingFrontend:
    """Collects requests into batches (size- or timeout-triggered) and runs
    them through the engine, on the engine's device.  An optional
    BatchMixMonitor watches the served shape mix.

    Duck-typed hooks, as in the JAX package: ``agent`` (``observe`` per
    served batch, ``heartbeat`` when idle), ``locality_controller``
    (``step`` per served batch) and ``feature_loader`` (``io_counters``
    polled every 16 batches; ``on_fault`` fires on entering and leaving a
    fault excursion).  With ``slow_lane=True`` a second thread serves the
    request groups whose predicted cost (a ``KeyedCostTracker`` EWMA keyed
    by ``(prompt_len, max_new_tokens)``) is a tail outlier, so cheap
    traffic keeps its p99 assembly wait (``assembly_wait_p99()``)."""

    def __init__(self, engine: ServeEngine, *, max_wait_s: float = 0.01,
                 mix_monitor: Optional[BatchMixMonitor] = None,
                 agent=None, locality_controller=None,
                 slow_lane: bool = False, slow_threshold: float = 4.0,
                 feature_loader=None, fault_rate_trigger: float = 0.0,
                 on_fault=None):
        self.engine = engine
        self.max_wait_s = max_wait_s
        self.mix_monitor = mix_monitor
        self.agent = agent
        self.feature_loader = feature_loader
        self.fault_rate_trigger = float(fault_rate_trigger)
        self.on_fault = on_fault
        self._faulted = False
        self.fault_events = 0
        self.locality_controller = locality_controller
        self.slow_lane = slow_lane
        self.cost_tracker = KeyedCostTracker(threshold=slow_threshold)
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # per-request assembly waits (submit -> generate start), split by
        # the lane that served them; bounded reservoirs for the p99
        self._wait_fast: List[float] = []
        self._wait_slow: List[float] = []
        self._wait_lock = threading.Lock()
        self._slow_queue: queue.Queue = queue.Queue()
        self.batches_served = 0
        self.slow_groups = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self._slow_thread: Optional[threading.Thread] = None
        if slow_lane:
            self._slow_thread = threading.Thread(target=self._run_slow,
                                                 daemon=True)
            self._slow_thread.start()

    def connect_fleet(self, transport, loader, *, host: str = "serve0",
                      join: bool = False, coord: str = "coord",
                      link_config=None, clock=time.monotonic):
        """Attach this frontend to a fleet over a message transport: the
        serving host then reports/heartbeats over the wire exactly like a
        training host (``consumes_stream=False`` — serving observes per
        request-group, so loader consumption comes from the stream
        cursor).  A coordinator outage never stalls serving; the host
        keeps batching on its last latched params."""
        from repro_torch.tuning.fleet import connect_host
        self.agent = connect_host(
            transport, host, loader, coord=coord, link_config=link_config,
            clock=clock, join=join, consumes_stream=False)
        return self.agent

    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> Request:
        req = Request(np.asarray(prompt, np.int32), max_new_tokens,
                      t_submit=time.perf_counter())
        self._queue.put(req)
        return req

    def assembly_wait_p99(self, *, slow: bool = False) -> float:
        """p99 of per-request assembly wait (submit to generate start) for
        the fast lane or, with ``slow=True``, the slow lane."""
        with self._wait_lock:
            samples = list(self._wait_slow if slow else self._wait_fast)
        return percentile(samples, 0.99)

    def _drain_batch(self) -> List[Request]:
        reqs: List[Request] = []
        try:
            reqs.append(self._queue.get(timeout=0.1))
        except queue.Empty:
            return reqs
        deadline = time.perf_counter() + self.max_wait_s
        while (len(reqs) < self.engine.max_batch
               and time.perf_counter() < deadline):
            try:
                reqs.append(self._queue.get_nowait())
            except queue.Empty:
                time.sleep(0.001)
        return reqs

    def _run(self):
        while not self._stop.is_set():
            t0 = time.perf_counter()
            reqs = self._drain_batch()
            if not reqs:
                if self.agent is not None:
                    self.agent.heartbeat()    # idle != dead
                continue
            t_form = time.perf_counter() - t0
            # group by (prompt_len, max_new) to keep shapes static
            by_shape = {}
            for r in reqs:
                by_shape.setdefault(
                    (len(r.prompt), r.max_new_tokens), []).append(r)
            for (plen, max_new), group in by_shape.items():
                if self.slow_lane and self.cost_tracker.is_slow(
                        (plen, max_new)):
                    self.slow_groups += 1
                    self._slow_queue.put((plen, max_new, group, t_form))
                else:
                    self._serve_group(plen, max_new, group, t_form,
                                      lane_slow=False)
                t_form = 0.0        # only the first group pays formation

    def _run_slow(self):
        while not self._stop.is_set():
            try:
                plen, max_new, group, t_form = self._slow_queue.get(
                    timeout=0.1)
            except queue.Empty:
                continue
            self._serve_group(plen, max_new, group, t_form, lane_slow=True)

    def _poll_faults(self) -> None:
        """Edge-triggered fault watch on the feature loader: fires
        ``on_fault(reason, io)`` once entering an excursion and once on
        heal, never continuously."""
        io = self.feature_loader.io_counters() or {}
        faulted = (io.get("fault_rate", 0.0) > self.fault_rate_trigger
                   or io.get("degraded", 0.0) >= 1.0)
        if faulted == self._faulted:
            return
        self._faulted = faulted
        self.fault_events += 1
        if self.on_fault is not None:
            self.on_fault("fault-drift" if faulted else "fault-heal", io)

    def _serve_group(self, plen: int, max_new: int, group: List[Request],
                     t_form: float, *, lane_slow: bool) -> None:
        prompts = np.stack([r.prompt for r in group])
        t1 = time.perf_counter()
        waits = [max(0.0, t1 - r.t_submit) for r in group if r.t_submit > 0]
        res = self.engine.generate(prompts, max_new)
        t_gen = time.perf_counter() - t1
        self.batches_served += 1
        try:
            self.cost_tracker.record((plen, max_new), t_gen / len(group))
            with self._wait_lock:
                reservoir = self._wait_slow if lane_slow else self._wait_fast
                reservoir.extend(waits)
                del reservoir[:-512]
            if self.agent is not None:
                # batch formation is the serving analogue of the
                # trainer's data wait; generate is the compute
                self.agent.observe(data_s=t_form, step_s=t_form + t_gen)
            if self.mix_monitor is not None:
                self.mix_monitor.record((plen, max_new))
            if self.locality_controller is not None:
                self.locality_controller.step()
            if (self.feature_loader is not None
                    and self.fault_rate_trigger > 0.0
                    and self.batches_served % 16 == 0):
                self._poll_faults()
        except Exception:  # noqa: BLE001 - observe/retune must not
            import traceback  # kill the serving thread
            traceback.print_exc()
        for i, r in enumerate(group):
            r.result.put(res.tokens[i])

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=5)
        if self._slow_thread is not None:
            self._slow_thread.join(timeout=5)
