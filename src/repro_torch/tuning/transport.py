"""Message transport for the fleet control plane (DESIGN.md §8).

The direct HostAgent <-> FleetCoordinator protocol is in-process
method calls: ``observe()`` invokes ``coordinator.ingest(report)`` on the
same stack, and every coordinator command reaches straight into the
agent's loader.  That shape cannot survive a real network — and a fleet
control plane that is only correct when messages always arrive and the
coordinator never dies is only correct in a simulator.

This module is the wire between them:

* every message is a **plain dict** (JSON-serializable after
  :func:`to_wire`) — ``HostReport`` and every coordinator->agent command
  (``apply_params``, ``reshard``, locality/cache pushes, barrier
  negotiation) crosses as data, never as an object reference, so a gRPC
  or etcd-watch backend can drop in behind :class:`LocalTransport`
  without touching ``FleetCoordinator.ingest``;
* :class:`FaultyTransport` injects seeded drop / delay / duplicate /
  reply-drop / partition faults, making "the network ate it" a
  first-class, deterministic test input;
* :class:`AgentLink` is the host's survival kit: bounded send queue,
  exponential backoff with jitter, report delta-encoding against the
  last acked base (heartbeat traffic stays O(hosts), not O(hosts x
  knobs)), replay-on-reconnect, and **fencing** — commands carry the
  leader's fence token and the link rejects anything older than the
  highest fence it has seen, so a deposed coordinator cannot move a
  host;
* :class:`LeaderLease` + :class:`SnapshotStore` are the in-process
  stand-ins for an etcd lease and key: a standby coordinator acquires
  the expired lease (fence strictly increases per acquisition) and
  restores the primary's snapshot.

Delivery semantics are at-least-once: the link retries sends, the
command path dedups by operation id (a retried or duplicated command
returns its cached reply instead of re-executing), and the report path
is guarded by the coordinator's stale-steps check.  Exactly-once
*delivery* is impossible under crash + loss (two generals); the fleet's
policy is to prefer a duplicate over a loss and to make re-application
idempotent.
"""
from __future__ import annotations

import dataclasses
import json
import random
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class TransportError(RuntimeError):
    """A message did not make it (drop/delay/partition/unknown peer)."""


class StaleLeaderError(TransportError):
    """A command was rejected because its fence token is older than one
    the receiver has already honoured — the sender has been deposed."""


# --------------------------------------------------------------------------
# wire encoding
# --------------------------------------------------------------------------
def to_wire(obj: Any) -> Any:
    """Normalize to plain JSON-able data: numpy arrays/scalars, tuples and
    dataclasses all become lists/dicts/python scalars."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return to_wire(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {str(k): to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_wire(v) for v in obj]
    return obj


def payload_bytes(msg: Dict[str, Any]) -> int:
    """Serialized size of a message — what a real wire would carry."""
    return len(json.dumps(to_wire(msg), separators=(",", ":"),
                          sort_keys=True, default=str))


def encode_report_delta(base: Dict[str, Any],
                        cur: Dict[str, Any]) -> Dict[str, Any]:
    """Delta-encode a full report dict against the last ACKED base.

    Only fields that changed are sent; the rolling ``batch_seconds``
    window is sent as its new tail (the ``steps`` delta counts the
    appends), and the ``io`` counter dict shrinks to its changed keys.
    """
    delta: Dict[str, Any] = {}
    for k, v in cur.items():
        if k == "batch_seconds":
            continue
        if base.get(k, "\0missing") != v:
            delta[k] = v
    if isinstance(delta.get("io"), dict) and isinstance(base.get("io"), dict):
        delta["io"] = {k: v for k, v in delta["io"].items()
                       if base["io"].get(k, "\0missing") != v}
    bs = cur.get("batch_seconds") or []
    n_new = int(cur.get("steps", 0)) - int(base.get("steps", 0))
    if bs != (base.get("batch_seconds") or []):
        tail = bs[-min(max(n_new, 0), len(bs)):] if n_new > 0 else bs
        delta["bs_tail"] = tail
        delta["bs_len"] = len(bs)
    return delta


def merge_report_delta(base: Dict[str, Any],
                       delta: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`encode_report_delta` given the same base."""
    full = dict(base)
    for k, v in delta.items():
        if k in ("bs_tail", "bs_len"):
            continue
        if k == "io" and isinstance(v, dict) \
                and isinstance(full.get("io"), dict):
            io = dict(full["io"])
            io.update(v)
            full["io"] = io
        else:
            full[k] = v
    if "bs_tail" in delta:
        merged = list(base.get("batch_seconds") or []) + list(delta["bs_tail"])
        full["batch_seconds"] = merged[-int(delta["bs_len"]):]
    return full


# --------------------------------------------------------------------------
# transports
# --------------------------------------------------------------------------
class LocalTransport:
    """In-process message fabric: named endpoints, synchronous ``call``.

    This is deliberately the *shape* of an RPC client: ``call(src, dst,
    msg) -> reply`` with :class:`TransportError` for anything that would
    be a timeout or unreachable peer.  A networked backend implements
    the same three methods.
    """

    def __init__(self):
        self._endpoints: Dict[str, Callable[[Dict[str, Any]],
                                            Dict[str, Any]]] = {}
        self.sent_msgs = 0
        self.sent_bytes = 0
        self.kind_msgs: Dict[str, int] = {}
        self.kind_bytes: Dict[str, int] = {}

    def register(self, name: str,
                 handler: Callable[[Dict[str, Any]], Dict[str, Any]],
                 *, replace: bool = False) -> None:
        if not replace and name in self._endpoints:
            raise ValueError(f"endpoint {name!r} already registered")
        self._endpoints[name] = handler

    def unregister(self, name: str) -> None:
        self._endpoints.pop(name, None)

    def endpoints(self) -> List[str]:
        return sorted(self._endpoints)

    def _account(self, msg: Dict[str, Any]) -> None:
        size = payload_bytes(msg)
        kind = str(msg.get("kind", "?"))
        self.sent_msgs += 1
        self.sent_bytes += size
        self.kind_msgs[kind] = self.kind_msgs.get(kind, 0) + 1
        self.kind_bytes[kind] = self.kind_bytes.get(kind, 0) + size

    def call(self, src: str, dst: str,
             msg: Dict[str, Any]) -> Dict[str, Any]:
        # fail fast BEFORE serialization: a refused connection costs the
        # caller nothing (a retry storm against a dead coordinator must
        # not tax the training loop), and nothing went on the wire
        handler = self._endpoints.get(dst)
        if handler is None:
            raise TransportError(f"{src} -> {dst}: no such endpoint")
        self._account(msg)
        return handler(to_wire(msg))

    def pump(self) -> int:
        """Deliver anything parked in-flight (no-op on the pure local
        fabric; :class:`FaultyTransport` delivers delayed messages)."""
        return 0


# back-compat friendly alias: the abstract protocol IS the local fabric
Transport = LocalTransport


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-call fault probabilities (seeded, deterministic)."""
    drop: float = 0.0          # message lost before the handler runs
    delay: float = 0.0         # parked; delivered stale at the next pump()
    duplicate: float = 0.0     # handler runs twice (first reply returned)
    reply_drop: float = 0.0    # handler runs, ack lost (caller sees timeout)
    seed: int = 0


class FaultyTransport(LocalTransport):
    """Seeded fault injection over :class:`LocalTransport`.

    * ``drop``       — the call raises, the handler never ran;
    * ``delay``      — the call raises NOW, the handler runs at the next
      ``pump()`` — the delayed original then arrives *after* any retry,
      which is exactly the reorder/stale-message anomaly the ingest
      guard and command dedup exist for;
    * ``duplicate``  — the handler runs twice back-to-back;
    * ``reply_drop`` — the handler ran but the caller sees a timeout —
      the fault that forces idempotent re-sends;
    * ``partition(a, b)`` — every call between a and b fails fast until
      ``heal``.
    """

    def __init__(self, faults: FaultSpec = FaultSpec()):
        super().__init__()
        self.faults = faults
        self.rng = random.Random(faults.seed)
        self._parked: List[Tuple[str, str, Dict[str, Any]]] = []
        self._cuts: set = set()
        self.dropped = 0
        self.delayed = 0
        self.duplicated = 0
        self.replies_dropped = 0

    # ---- partitions --------------------------------------------------------
    def partition(self, a: str, b: str) -> None:
        self._cuts.add(frozenset((a, b)))

    def isolate(self, name: str, others: List[str]) -> None:
        for o in others:
            self.partition(name, o)

    def heal(self, a: str, b: Optional[str] = None) -> None:
        if b is not None:
            self._cuts.discard(frozenset((a, b)))
        else:
            self._cuts = {c for c in self._cuts if a not in c}

    def heal_all(self) -> None:
        self._cuts.clear()

    def partitioned(self, a: str, b: str) -> bool:
        return frozenset((a, b)) in self._cuts

    # ---- faulted delivery --------------------------------------------------
    def call(self, src: str, dst: str,
             msg: Dict[str, Any]) -> Dict[str, Any]:
        # connection-refused paths fail fast, pre-serialization (see
        # LocalTransport.call) — and pre-rng, so the seeded fault stream
        # is independent of how often a caller retries into a partition
        if self.partitioned(src, dst):
            raise TransportError(f"{src} -> {dst}: partitioned")
        handler = self._endpoints.get(dst)
        if handler is None:
            raise TransportError(f"{src} -> {dst}: no such endpoint")
        self._account(msg)
        msg = to_wire(msg)
        f = self.faults
        r = self.rng.random()
        if r < f.drop:
            self.dropped += 1
            raise TransportError(f"{src} -> {dst}: dropped")
        if r < f.drop + f.delay:
            self.delayed += 1
            self._parked.append((src, dst, msg))
            raise TransportError(f"{src} -> {dst}: delayed (timeout)")
        if self.rng.random() < f.duplicate:
            self.duplicated += 1
            reply = handler(msg)
            handler(msg)
            return reply
        reply = handler(msg)
        if self.rng.random() < f.reply_drop:
            self.replies_dropped += 1
            raise TransportError(f"{src} -> {dst}: reply dropped")
        return reply

    def pump(self) -> int:
        """Deliver every parked (delayed) message; replies are discarded
        — from the receiver's view these are stale retransmits."""
        parked, self._parked = self._parked, []
        n = 0
        for src, dst, msg in parked:
            if self.partitioned(src, dst):
                continue
            handler = self._endpoints.get(dst)
            if handler is None:
                continue
            try:
                handler(msg)
                n += 1
            except Exception:
                pass
        return n


# --------------------------------------------------------------------------
# leader election + snapshots (in-process etcd stand-ins)
# --------------------------------------------------------------------------
class LeaderLease:
    """TTL lease with a monotonically increasing fence token.

    ``acquire`` grants the lease when it is free/expired (bumping the
    fence) or refreshes it for the current holder (same fence).  Any
    command stamped with fence ``f`` is provably from the leader of
    lease generation ``f``; receivers reject ``f' < f_seen`` — the
    classic fencing-token construction.
    """

    def __init__(self, *, ttl_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.ttl_s = ttl_s
        self.clock = clock
        self._owner: Optional[str] = None
        self._expires = float("-inf")
        self._fence = 0

    def acquire(self, owner: str) -> Optional[int]:
        now = self.clock()
        if self._owner == owner:
            self._expires = now + self.ttl_s
            return self._fence
        if self._owner is None or now > self._expires:
            self._owner = owner
            self._expires = now + self.ttl_s
            self._fence += 1
            return self._fence
        return None

    def refresh(self, owner: str) -> bool:
        if self._owner == owner and self.clock() <= self._expires:
            self._expires = self.clock() + self.ttl_s
            return True
        return False

    def release(self, owner: str) -> None:
        if self._owner == owner:
            self._owner = None
            self._expires = float("-inf")

    def holder(self) -> Optional[str]:
        if self._owner is not None and self.clock() > self._expires:
            return None
        return self._owner

    @property
    def fence(self) -> int:
        return self._fence


class SnapshotStore:
    """Versioned single-key snapshot store (the etcd key the coordinator
    checkpoints into).  Values are wire-normalized on put so a restore
    can never alias live coordinator state."""

    def __init__(self):
        self._value: Optional[Dict[str, Any]] = None
        self.seq = 0

    def put(self, state: Dict[str, Any]) -> int:
        self._value = to_wire(state)
        self.seq += 1
        return self.seq

    def get(self) -> Optional[Dict[str, Any]]:
        return None if self._value is None else to_wire(self._value)


# --------------------------------------------------------------------------
# the host side: AgentLink
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LinkConfig:
    max_queue: int = 64          # bounded: a long partition drops OLDEST
    retries: int = 6             # immediate retransmits per send
    backoff_s: float = 0.05     # first backoff after retries exhausted
    backoff_mult: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.5          # +[0, jitter) * backoff, seeded
    dedup_cache: int = 512       # remembered command replies
    seed: int = 0


class AgentLink:
    """One host's connection to the coordinator endpoint.

    Outbound (reports): bounded queue + exponential backoff with jitter;
    a report that cannot be sent is parked, training is NEVER blocked.
    On reconnect the parked backlog is replayed in order (the
    coordinator's stale-steps guard makes replay harmless) and the
    current report re-syncs the host.  Reports are delta-encoded against
    the last acked base; the coordinator answers ``need_full`` when its
    base disagrees (e.g. after a failover), which forces one full resend
    — the delta protocol is self-healing.

    Inbound (commands): fence check first — a command whose fence is
    below the highest this link has seen is rejected and recorded
    (``rejected``); then op-id dedup — a duplicated/replayed command
    returns its cached reply instead of executing twice.
    """

    def __init__(self, transport: LocalTransport, host: str, *,
                 coord: str = "coord", config: Optional[LinkConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.transport = transport
        self.host = host
        self.coord = coord
        self.cfg = config or LinkConfig()
        self.clock = clock
        # stable per-host seed (str.__hash__ is process-randomized)
        self.rng = random.Random(
            self.cfg.seed * 1000003 + sum(ord(c) for c in host))
        self.agent: Any = None
        # fencing: highest leader fence seen; stale commands are rejected
        self.fence = -1
        self.rejected: List[Dict[str, Any]] = []
        self._done: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        # outbound report queue
        self._pending: deque = deque(maxlen=self.cfg.max_queue)
        self._last_acked: Optional[Dict[str, Any]] = None
        self._force_full = True
        self._backoff = self.cfg.backoff_s
        self._next_try = 0.0
        self.connected = False
        self.evicted = False
        # counters (tests + benches)
        self.full_sent = 0
        self.delta_sent = 0
        self.dropped_reports = 0
        self.send_failures = 0

    # ---- lifecycle ---------------------------------------------------------
    def bind(self, agent: Any) -> "AgentLink":
        """Attach the host agent: the link becomes its transport endpoint
        and dispatches inbound commands to ``agent.handle_command``."""
        self.agent = agent
        self.transport.register(self.host, self._handle, replace=True)
        return self

    def register(self) -> Dict[str, Any]:
        """Announce this host to the coordinator (member spec crosses as
        data — the coordinator builds its shard-map mirror from it)."""
        reply = self._call_retry({"kind": "register", "host": self.host,
                                 "spec": to_wire(self.agent.member_spec())})
        self._saw_fence(reply)
        self.connected = True
        self.evicted = False
        return reply

    def join(self) -> Dict[str, Any]:
        """Mid-run admission: the coordinator reshards incumbents and
        aligns this host at the returned barrier (via commands back over
        this same link)."""
        reply = self._call_retry({"kind": "join", "host": self.host,
                                 "spec": to_wire(self.agent.member_spec())})
        self._saw_fence(reply)
        self.connected = True
        self.evicted = False
        return reply

    def leave(self) -> None:
        try:
            self._call_retry({"kind": "leave", "host": self.host})
        except TransportError:
            pass

    # ---- outbound: reports -------------------------------------------------
    def send_report(self, full: Dict[str, Any]) -> bool:
        """Queue + try to deliver one full report dict.  Returns True when
        the coordinator acked it (False = parked for replay; training
        continues on latched params either way)."""
        if self.evicted:
            return False
        if len(self._pending) == self._pending.maxlen:
            self.dropped_reports += 1
        self._pending.append(to_wire(full))
        if self.clock() < self._next_try:
            return False
        return self._flush()

    def beat(self) -> bool:
        """Cheap liveness when there is no observation to report."""
        if self.evicted:
            return False
        try:
            reply = self.transport.call(
                self.host, self.coord,
                {"kind": "beat", "host": self.host})
            self._saw_fence(reply)
            return bool(reply.get("ok"))
        except TransportError:
            return False

    def cast(self, kind: str, **fields: Any) -> bool:
        """One-way best-effort message (drift signals, locality
        proposals) — losing one is safe, the condition re-fires."""
        try:
            self.transport.call(self.host, self.coord,
                                {"kind": kind, "host": self.host, **fields})
            return True
        except TransportError:
            return False

    def _flush(self) -> bool:
        if not self._pending:
            return True
        base = self._last_acked
        if len(self._pending) == 1 and base is not None \
                and not self._force_full:
            cur = self._pending[-1]
            msg = {"kind": "report", "host": self.host, "delta": True,
                   "base": int(base.get("steps", -1)),
                   "patch": encode_report_delta(base, cur)}
        else:
            msg = {"kind": "report", "host": self.host,
                   "reports": list(self._pending)}
        reply = self._try_call(msg)
        if reply is None:
            self._on_send_failure()
            return False
        self._saw_fence(reply)
        if reply.get("evicted"):
            # the coordinator resharded around us during a partition; our
            # shard no longer exists.  Stop reporting — the driver decides
            # whether to rejoin (with a fresh stream) via ``join()``.
            self.evicted = True
            self.connected = False
            self._pending.clear()
            return False
        if reply.get("need_full"):
            # coordinator lost our delta base (failover) — resend full
            self._force_full = True
            msg = {"kind": "report", "host": self.host,
                   "reports": list(self._pending)}
            reply = self._try_call(msg)
            if reply is None:
                self._on_send_failure()
                return False
            self._saw_fence(reply)
        if reply.get("ok"):
            if msg.get("delta"):
                self.delta_sent += 1
            else:
                self.full_sent += 1
            self._last_acked = self._pending[-1]
            self._pending.clear()
            self._force_full = False
            self._backoff = self.cfg.backoff_s
            self._next_try = 0.0
            self.connected = True
            return True
        return False

    def _try_call(self, msg: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        for _ in range(max(1, self.cfg.retries)):
            try:
                return self.transport.call(self.host, self.coord, msg)
            except TransportError:
                continue
        return None

    def _call_retry(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        reply = self._try_call(msg)
        if reply is None:
            raise TransportError(
                f"{self.host}: {msg.get('kind')} to {self.coord} failed "
                f"after {self.cfg.retries} retries")
        return reply

    def _on_send_failure(self) -> None:
        self.send_failures += 1
        self.connected = False
        jitter = 1.0 + self.cfg.jitter * self.rng.random()
        self._next_try = self.clock() + self._backoff * jitter
        self._backoff = min(self.cfg.max_backoff_s,
                            self._backoff * self.cfg.backoff_mult)

    def _saw_fence(self, reply: Dict[str, Any]) -> None:
        f = reply.get("fence")
        if f is not None:
            self.fence = max(self.fence, int(f))

    # ---- inbound: fenced, idempotent command dispatch ----------------------
    def _handle(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        kind = msg.get("kind")
        if kind == "ping":
            return {"ok": True, "fence": self.fence, "host": self.host}
        if kind != "cmd":
            return {"ok": False, "error": f"unknown kind {kind!r}"}
        fence = int(msg.get("fence", -1))
        if fence < self.fence:
            self.rejected.append({"op": msg.get("op"), "fence": fence,
                                  "current": self.fence,
                                  "id": msg.get("id")})
            return {"ok": False, "error": "stale-fence", "fence": self.fence}
        self.fence = fence
        oid = msg.get("id")
        if oid is not None and oid in self._done:
            return self._done[oid]
        try:
            result = self.agent.handle_command(msg.get("op"),
                                               msg.get("args") or {})
            reply = {"ok": True, "result": to_wire(result),
                     "fence": self.fence}
        except Exception as e:  # surfaced to the sender, not raised here
            reply = {"ok": False,
                     "error": f"{type(e).__name__}: {e}",
                     "fence": self.fence}
        if oid is not None:
            self._done[oid] = reply
            while len(self._done) > self.cfg.dedup_cache:
                self._done.popitem(last=False)
        return reply
