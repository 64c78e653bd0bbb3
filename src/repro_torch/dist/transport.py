"""Live control-plane transport (paper §3.2: failures/joins as live events).

The port of ``repro/dist/transport.py``.  Everything but the multi-host
store is framework-neutral and unchanged; ``KVStoreTransport`` runs over a
``torch.distributed.Store`` (a ``TCPStore``, or the default process
group's store) through ``StoreKV``, an adapter with the reference's
key-value client surface.

The elasticity half of the paper assumes cluster-membership changes reach
the coordinator as *live events*: workers publish heartbeats, the
coordinator consumes them, detection (``HeartbeatMonitor.failed()`` /
``stragglers()``) drives ``ClusterCoordinator.handle_failure`` /
``handle_join``, and re-plan results flow back to the workers as
epoch-boundary reconfiguration events.  This module is that transport.

Transport contract
------------------

A transport is an append-only, per-topic message log with at-least-once
delivery and a deterministic total order per topic:

  - ``publish(topic, payload) -> seq`` appends one JSON-serializable dict
    and returns its sequence number (monotone per topic).  A disconnected
    endpoint may silently drop the publish (returns -1) — exactly how a
    partitioned worker's beats die.
  - ``poll(topic, since) -> [(seq, payload), ...]`` returns every message
    with ``seq >= since`` in ascending seq order.  Consumers track their
    own cursor; polling never consumes destructively, so any number of
    readers (every worker polls the reconfig topic) can share one topic.
  - ``compact(topic, upto) -> int`` garbage-collects the log prefix below
    ``upto`` and returns the new low-water mark (``low_water(topic)``).
    Compaction is monotone (``upto`` below the current mark is a no-op)
    and must only be driven from an aggregated consumer-ack cursor: a
    consumer polling below the mark would silently miss messages, which
    the fake CI transport turns into a hard error.  Without compaction a
    long job's heartbeat topic grows without bound — one beat per worker
    per step, forever.

Three implementations, one contract:

  - ``InProcessBus`` — plain shared-memory topic lists; the reference
    implementation for single-process tests and the trace-driven cluster
    simulator (``repro_torch.sim.cluster_sim`` replays heartbeat-loss traces
    through the exact consumption path below).
  - ``fake_transport_pair()`` — two distinct endpoint views over one bus
    that force every payload through JSON (catching payloads a real
    multi-host KV store could not carry) and support ``disconnect()``
    (beat loss injection for CI).
  - ``KVStoreTransport`` — the multi-host implementation, backed by a
    ``torch.distributed.Store``.  Keys are
    ``{ns}/{topic}/{counter:012d}.{uid}`` so a lexicographic directory
    listing is a deterministic global order across publishers.

Protocol layer
--------------

``WorkerClient`` (worker side) publishes beats on the heartbeat topic and
polls the reconfig topic; ``CoordinatorLoop`` (coordinator side) drains
beats into a ``HeartbeatMonitor``, fires ``handle_failure`` on beat
timeout, treats beats from unknown worker ids as explicit joins
(``monitor.join`` + idempotent ``handle_join``), logs stragglers, and
publishes every re-plan back as a reconfiguration event.  Beats carry the
worker's consumed reconfig cursor as an *ack*, and the coordinator
aggregates the acks of live workers into the low-water mark it compacts
the topics to (``gc_every``) — the key log stays bounded across a long
job without any consumer ever losing a message.

``CoordinatorLease`` elects the coordinator itself: an epoch-numbered,
heartbeat-renewed lease record on its own topic.  When the holder dies its
renewals stop; any worker that observes the lease stale past its timeout
claims the next epoch, with epoch ties broken toward the lowest worker id
so concurrent claimants converge without a CAS.  A fresh holder calls
``CoordinatorLoop.bootstrap_from_log()`` to reconstruct monitor +
coordinator state from the topic logs — mitigations the previous holder
already fired are adopted, not re-fired.
"""
from __future__ import annotations

import json
import os
import socket
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

HEARTBEAT_TOPIC = "hb"
RECONFIG_TOPIC = "reconfig"
LEASE_TOPIC = "lease"


class InProcessBus:
    """Reference transport: per-topic append-only lists in process memory.

    Sequence numbers are absolute list indices (compaction shifts the
    storage but never renumbers), so ``poll(topic, since)`` is a
    constant-time slice and replay is trivially deterministic.
    """

    def __init__(self):
        self._topics: Dict[str, List[dict]] = {}
        self._base: Dict[str, int] = {}  # per-topic low-water mark

    def publish(self, topic: str, payload: dict) -> int:
        log = self._topics.setdefault(topic, [])
        log.append(payload)
        return self._base.get(topic, 0) + len(log) - 1

    def poll(self, topic: str, since: int = 0) -> List[Tuple[int, dict]]:
        log = self._topics.get(topic, ())
        base = self._base.get(topic, 0)
        return [(i, log[i - base])
                for i in range(max(since, base), base + len(log))]

    def low_water(self, topic: str) -> int:
        return self._base.get(topic, 0)

    def backlog(self, topic: str) -> int:
        """Messages currently retained (published minus compacted) — the
        quantity GC must keep bounded on a long-running job."""
        return len(self._topics.get(topic, ()))

    def compact(self, topic: str, upto: int) -> int:
        """Drop messages with seq < ``upto``.  Monotone and clamped to the
        log head; surviving messages keep their sequence numbers."""
        log = self._topics.get(topic)
        base = self._base.get(topic, 0)
        if log is None:
            return base
        upto = min(upto, base + len(log))
        if upto > base:
            del log[: upto - base]
            self._base[topic] = upto
            base = upto
        return base


class FakeTransportEndpoint:
    """One endpoint of the fake two-endpoint transport (CI implementation).

    Wraps a shared ``InProcessBus`` but forces every payload through a JSON
    round-trip on both publish and poll — a payload that would not survive
    a real multi-host KV store (arbitrary objects, non-string keys) fails
    here too, in-process, where the test can see it.  ``disconnect()``
    models a partitioned/crashed endpoint: its publishes are silently
    dropped (returns -1), which is exactly how a worker's heartbeats die in
    the live-failure tests.

    Compaction safety is *asserted* here: polling from a cursor below the
    topic's low-water mark means the consumer would silently miss
    compacted messages on a real KV store — the fake raises instead, so a
    GC driver that compacts past a live consumer's ack fails in CI, not in
    production.  (A fresh consumer that intends to start at the compacted
    head polls from ``low_water(topic)``.)
    """

    def __init__(self, bus: InProcessBus, name: str):
        self.bus = bus
        self.name = name
        self.connected = True
        self.dropped = 0

    def publish(self, topic: str, payload: dict) -> int:
        wire = json.loads(json.dumps(payload))  # serialization enforced
        if not self.connected:
            self.dropped += 1
            return -1
        return self.bus.publish(topic, wire)

    def poll(self, topic: str, since: int = 0) -> List[Tuple[int, dict]]:
        if not self.connected:
            return []
        lw = self.bus.low_water(topic)
        if since < lw:
            raise RuntimeError(
                f"{self.name}: poll({topic!r}, since={since}) reads below "
                f"the compacted low-water mark {lw} — the consumer ack "
                f"aggregation compacted past a live cursor"
            )
        return [(seq, json.loads(json.dumps(p)))
                for seq, p in self.bus.poll(topic, since)]

    def low_water(self, topic: str) -> int:
        return self.bus.low_water(topic)

    def compact(self, topic: str, upto: int) -> int:
        return self.bus.compact(topic, upto)

    def disconnect(self) -> None:
        self.connected = False

    def reconnect(self) -> None:
        self.connected = True


def fake_transport_pair() -> Tuple[FakeTransportEndpoint, FakeTransportEndpoint]:
    """(worker_end, coordinator_end) over one shared in-process bus, with
    JSON serialization enforced at both endpoints (the CI stand-in for the
    multi-host KV-store transport)."""
    bus = InProcessBus()
    return FakeTransportEndpoint(bus, "worker"), \
        FakeTransportEndpoint(bus, "coordinator")


class StoreKV:
    """The reference's key-value client surface over a
    ``torch.distributed.Store``: ``key_value_set(key, value,
    allow_overwrite=False)``, ``key_value_dir_get(prefix)`` and
    ``key_value_delete(key)``.

    Three hazards of the store shape it:

      - ``Store.get`` on a missing key blocks until the store's timeout, so
        a directory read lists first (``list_keys``, filtered by the
        prefix: the store also holds the process group's rendezvous keys)
        and reads only the keys the listing returned (``multi_get``).
        ``list_keys`` is recent API; a store without it is refused.
      - ``Store.set`` overwrites silently, where the transport relies on
        write-once message keys: a key written without ``allow_overwrite``
        that already exists raises, as the reference's service does.
      - Message keys are write-once, so their values are cached after the
        first read and a poll reads only keys it has not seen.  The
        low-water keys (``{ns}/.lw/{topic}``) are the one family written
        with ``allow_overwrite``, and are read afresh every time.
    """

    def __init__(self, store):
        if not hasattr(store, "list_keys"):
            raise RuntimeError(
                f"KVStoreTransport needs Store.list_keys, which this torch's "
                f"{type(store).__name__} lacks"
            )
        self.store = store
        self._cache: Dict[str, str] = {}

    def key_value_set(self, key: str, value: str,
                      allow_overwrite: bool = False) -> None:
        if not allow_overwrite and self.store.check([key]):
            raise RuntimeError(f"key {key} already exists: message keys are "
                               f"write-once")
        self.store.set(key, value)

    def key_value_dir_get(self, prefix: str) -> List[Tuple[str, str]]:
        keys = sorted(k for k in self.store.list_keys() if k.startswith(prefix))
        if "/.lw/" in prefix:  # the mutable low-water marks: read afresh
            return list(zip(keys, self._read(keys)))
        new = [k for k in keys if k not in self._cache]
        self._cache.update(zip(new, self._read(new)))
        return [(k, self._cache[k]) for k in keys]

    def _read(self, keys: List[str]) -> List[str]:
        """The values of ``keys``, every one of them listed just before."""
        return [v.decode() for v in self.store.multi_get(keys)] if keys else []

    def key_value_delete(self, key: str) -> None:
        self.store.delete_key(key)
        self._cache.pop(key, None)


class KVStoreTransport:
    """Multi-host transport over a ``torch.distributed.Store``.

    Messages are stored under ``{namespace}/{topic}/{counter:012d}.{uid}``
    where ``counter`` is this publisher's local per-topic counter and
    ``uid`` identifies the publisher (host-pid by default): the zero-padded
    counter makes the lexicographic directory listing a deterministic
    total order, with publisher uid breaking counter ties stably.

    ``client`` injects any object with the reference's client surface
    (``key_value_set(key, value, allow_overwrite=False)``,
    ``key_value_dir_get(prefix) -> [(key, value), ...]`` and
    ``key_value_delete(key)``) — tests pass a dict-backed fake — or a
    ``torch.distributed.Store`` (a ``TCPStore`` every host reaches), which
    is wrapped in ``StoreKV``.  The default is the default process group's
    store; without a process group the constructor raises ``RuntimeError``
    (use ``InProcessBus`` / ``fake_transport_pair`` for single-process
    runs).

    Sequence numbers are assigned *per consumer instance*, stably: the
    first poll seeds the numbering at the topic's persisted low-water mark,
    and every later poll numbers only keys it has not seen before (in
    lexicographic order among the new ones).  A key that lands "in the
    middle" of the lexicographic order after a slow publisher flushes (its
    counter is small, so it sorts before keys another consumer already
    numbered) therefore gets the *next* sequence number instead of
    renumbering — and shifting — everything behind it.  Cursors stay
    monotone: a consumer never skips and never re-reads a key, which is
    the delivery contract ``CoordinatorLoop.pump`` relies on (it still
    sorts by seq defensively, see the pump docstring).

    ``compact(topic, upto)`` deletes the first ``upto - low_water`` keys in
    lexicographic order and persists the new mark under
    ``{ns}/.lw/{topic}`` (outside the message prefix, so directory polls
    never see it).
    """

    def __init__(self, namespace: str = "reproctl", *,
                 client: Optional[Any] = None, uid: Optional[str] = None):
        if client is None:
            client = _default_store()
            if client is None:
                raise RuntimeError(
                    "KVStoreTransport needs torch.distributed.init_process_group() "
                    "(no process group store is active) or a store passed as "
                    "client=; use InProcessBus or fake_transport_pair() for "
                    "single-process runs"
                )
        if not hasattr(client, "key_value_dir_get"):
            client = StoreKV(client)
        self._client = client
        self._ns = namespace.strip("/")
        self._uid = uid if uid is not None else \
            f"{socket.gethostname()}-{os.getpid()}"
        self._counters: Dict[str, int] = {}
        self._key_seq: Dict[str, Dict[str, int]] = {}  # topic -> key -> seq
        self._next_seq: Dict[str, int] = {}

    def publish(self, topic: str, payload: dict) -> int:
        n = self._counters.get(topic, 0)
        self._counters[topic] = n + 1
        key = f"{self._ns}/{topic}/{n:012d}.{self._uid}"
        self._client.key_value_set(key, json.dumps(payload, sort_keys=True))
        return n

    def _dir(self, topic: str) -> List[Tuple[str, str]]:
        return sorted(self._client.key_value_dir_get(f"{self._ns}/{topic}/"),
                      key=lambda kv: kv[0])

    def _numbered(self, topic: str) -> List[Tuple[int, str, str]]:
        """Current directory listing as stable (seq, key, value) triples,
        ascending seq (= this consumer's arrival order, lexicographic
        within one poll)."""
        entries = self._dir(topic)
        amap = self._key_seq.setdefault(topic, {})
        nxt = self._next_seq.get(topic)
        if nxt is None:
            nxt = self.low_water(topic)
        for k, _v in entries:
            if k not in amap:
                amap[k] = nxt
                nxt += 1
        self._next_seq[topic] = nxt
        return sorted((amap[k], k, v) for k, v in entries)

    def poll(self, topic: str, since: int = 0) -> List[Tuple[int, dict]]:
        return [(seq, json.loads(v))
                for seq, _k, v in self._numbered(topic) if seq >= since]

    def low_water(self, topic: str) -> int:
        for k, v in self._client.key_value_dir_get(f"{self._ns}/.lw/"):
            if k == f"{self._ns}/.lw/{topic}":
                return int(v)
        return 0

    def compact(self, topic: str, upto: int) -> int:
        lw = self.low_water(topic)
        numbered = self._numbered(topic)
        upto = min(upto, lw + len(numbered))
        if upto <= lw:
            return lw
        doomed = [(seq, k) for seq, k, _v in numbered if seq < upto]
        for _seq, key in doomed:
            self._client.key_value_delete(key)
            self._key_seq[topic].pop(key, None)
        # message keys are write-once: the low-water mark is the one key we
        # mutate, so it needs the explicit overwrite flag
        self._client.key_value_set(f"{self._ns}/.lw/{topic}", str(upto),
                                   allow_overwrite=True)
        return upto


def _default_store():
    """The default process group's store, or None without a process group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed.distributed_c10d import _get_default_store

    return _get_default_store()


# ---------------------------------------------------------------------------
# Protocol layer: heartbeat publication + coordinator-side consumption
# ---------------------------------------------------------------------------


class WorkerClient:
    """Worker-side protocol endpoint: publish beats, poll reconfig events.

    One per worker process.  ``beat(step)`` publishes this worker's
    liveness + progress, carrying the worker's consumed reconfig cursor as
    an *ack* — the coordinator aggregates live workers' acks into the
    low-water mark it compacts the reconfig topic to, so no worker ever
    loses an event to GC.  ``poll_reconfig()`` returns the reconfiguration
    events (re-plan results the coordinator pushed back) published since
    the last poll — the worker applies them at its next epoch boundary.
    """

    def __init__(self, transport, worker_id: int):
        self.transport = transport
        self.worker_id = worker_id
        self._seen_reconfig = 0

    def beat(self, step: int) -> int:
        return self.transport.publish(
            HEARTBEAT_TOPIC, {"worker": self.worker_id, "step": step,
                              "ack": self._seen_reconfig}
        )

    def poll_reconfig(self) -> List[dict]:
        msgs = sorted(self.transport.poll(RECONFIG_TOPIC, self._seen_reconfig),
                      key=lambda sp: sp[0])
        out = []
        for seq, p in msgs:
            if seq < self._seen_reconfig:  # at-least-once: drop re-delivery
                continue
            self._seen_reconfig = seq + 1
            out.append(p)
        return out


class CoordinatorLoop:
    """Coordinator-side consumption: beats in, failure handling, reconfig out.

    ``pump()`` is the whole live control plane for one tick:

      1. drain new beats into the ``HeartbeatMonitor`` — a beat from an
         unknown worker id is an explicit *join* (``monitor.join`` +
         idempotent ``ClusterCoordinator.handle_join``, so re-delivered
         announcements for an already-healthy device are no-ops),
      2. every worker ``monitor.failed()`` reports is acknowledged
         (``monitor.forget`` — detection fires once per loss, not every
         tick), logged, and driven through ``handle_failure`` — the
         foreground re-plans onto the exact surviving pool,
      3. each re-plan is published on the reconfig topic so workers pick it
         up at their next epoch boundary (``WorkerClient.poll_reconfig``),
      4. newly lagging workers are logged as stragglers (recovered workers
         re-arm),
      5. when ``admission_bound`` is set, every churn event triggers a
         continuous-admission re-sweep (``ClusterCoordinator.readmit``) —
         the DeepPool requirement that admission runs continuously, not
         once at submesh-carving time,
      6. with ``gc_every`` > 0, every that-many pumps the topics are
         compacted: the heartbeat topic up to the loop's own consumed
         cursor (it is the only hb consumer), the reconfig topic up to the
         minimum ack carried in live workers' beats (acks of dead/forgotten
         workers are dropped, or one crashed worker would pin the log
         forever).

    Beat consumption is ordered and de-duplicated: polled messages are
    sorted by sequence id and any seq below the consumed cursor is skipped
    before it reaches the monitor.  A transport whose poll returns
    overlapping or out-of-arrival-order batches (the KV store merges
    per-publisher counters lexicographically, and at-least-once delivery
    may repeat a tail) would otherwise replay old beats — resurrecting a
    worker the loop already declared dead and double-firing the mitigation
    on the next timeout.

    ``log`` is a ``MitigationLog`` (attached lazily by the train loop when
    None).  Returns the reconfiguration events published this pump.
    """

    def __init__(self, transport, monitor, coordinator=None, log=None, *,
                 admission_bound: Optional[float] = None,
                 allow_joins: bool = True,
                 on_replan: Optional[Callable] = None,
                 gc_every: int = 0):
        self.transport = transport
        self.monitor = monitor
        self.coordinator = coordinator
        self.log = log
        self.admission_bound = admission_bound
        self.allow_joins = allow_joins
        self.on_replan = on_replan
        self.gc_every = gc_every
        self._seen_beats = 0
        self._flagged: set = set()
        self._acks: Dict[int, int] = {}  # worker -> consumed reconfig cursor
        self._pumps = 0

    # -- helpers ------------------------------------------------------------

    def _log(self, kind: str, **info) -> None:
        if self.log is not None:
            self.log.log(kind, **info)

    def _publish_replan(self, plan, *, reason: str, worker: int) -> dict:
        ev = {
            "action": "replan",
            "reason": reason,
            "worker": worker,
            "gpus": plan.num_gpus,
            "devices": sorted(self.coordinator.healthy),
        }
        self.transport.publish(RECONFIG_TOPIC, ev)
        self._log("replan", reason=reason, worker=worker, gpus=plan.num_gpus)
        if self.on_replan is not None:
            self.on_replan(ev)
        return ev

    def _readmit(self, reason: str) -> None:
        if self.admission_bound is not None and self.coordinator is not None:
            self.coordinator.readmit(self.admission_bound, reason=reason)

    # -- the consumption path ----------------------------------------------

    def pump(self) -> List[dict]:
        out: List[dict] = []
        msgs = sorted(self.transport.poll(HEARTBEAT_TOPIC, self._seen_beats),
                      key=lambda sp: sp[0])
        for seq, m in msgs:
            if seq < self._seen_beats:  # re-delivered tail: already consumed
                continue
            self._seen_beats = seq + 1
            w, step = int(m["worker"]), int(m.get("step", 0))
            if "ack" in m:
                self._acks[w] = max(self._acks.get(w, 0), int(m["ack"]))
            if w not in self.monitor.last:
                if not self.allow_joins:
                    continue
                self.monitor.join(w)
                self._log("join", worker=w)
                if self.coordinator is not None:
                    new_plan = self.coordinator.handle_join([w])
                    if new_plan is not None:  # idempotent: None = no-op join
                        out.append(self._publish_replan(
                            new_plan, reason="join", worker=w
                        ))
                        self._readmit("join")
            self.monitor.beat(w, step)
        for w in self.monitor.failed():
            self.monitor.forget(w)  # ack: one detection per loss
            self._acks.pop(w, None)  # a dead worker's ack must not pin GC
            self._log("failure_detected", worker=w)
            self._flagged.discard(w)
            if self.coordinator is not None and w in self.coordinator.healthy:
                new_plan = self.coordinator.handle_failure(w)
                if new_plan is not None:
                    out.append(self._publish_replan(
                        new_plan, reason="failure", worker=w
                    ))
                self._readmit("failure")
        lagging = set(self.monitor.stragglers())
        for w in sorted(lagging - self._flagged):
            self._log("straggler_worker", worker=w)
        self._flagged = lagging  # recovered workers re-arm
        self._pumps += 1
        if self.gc_every > 0 and self._pumps % self.gc_every == 0:
            self.gc()
        return out

    def gc(self) -> Tuple[int, int]:
        """Compact the topics to the aggregated consumer cursors: the hb
        topic up to this loop's consumed cursor, the reconfig topic up to
        the minimum ack among live (monitored) workers.  The newest
        reconfiguration event is always retained even when every worker has
        acked it — it is the pool of record ``bootstrap_from_log`` restores
        the coordinator from after a failover; compacting it away would
        reset a new holder to the full initial pool and re-fire every
        mitigation the old holder already handled.  Returns the two new
        low-water marks."""
        hb_lw = self.transport.compact(HEARTBEAT_TOPIC, self._seen_beats)
        live_acks = [a for w, a in self._acks.items() if w in self.monitor.last]
        rc_lw = self.transport.low_water(RECONFIG_TOPIC)
        if live_acks and len(live_acks) == len(self.monitor.last):
            # only compact once every live worker has acked (a worker that
            # never beat with an ack could still be at an older cursor)
            tail = self.transport.poll(RECONFIG_TOPIC, rc_lw)
            head = max((s for s, _ in tail), default=rc_lw - 1) + 1
            rc_lw = self.transport.compact(
                RECONFIG_TOPIC, min(min(live_acks), head - 1)
            )
        return hb_lw, rc_lw

    def bootstrap_from_log(self) -> dict:
        """Reconstruct coordinator-side state from the topic logs after
        winning the lease (coordinator failover).

        Mitigations the previous holder already fired must not re-fire: the
        surviving pool is adopted from the last reconfiguration event still
        in the log (``ClusterCoordinator.restore_pool`` re-plans silently
        when needed), so a worker the old coordinator already re-planned
        away is neither re-joined nor re-detected.  Every worker of the
        restored pool is (re)joined with a fresh grace period — workers
        that died *around* the failover stop beating and are detected by
        the normal ``pump()`` path one heartbeat timeout later.  The beat
        cursor fast-forwards to the log tail (old beats are membership
        evidence, not progress), and worker acks are re-seeded from the
        beat tail so GC can resume.  Returns a summary dict (logged as a
        ``coordinator_failover`` mitigation).
        """
        rc_lw = self.transport.low_water(RECONFIG_TOPIC)
        reconfigs = sorted(self.transport.poll(RECONFIG_TOPIC, rc_lw),
                           key=lambda sp: sp[0])
        pool: Optional[List[int]] = None
        for _seq, ev in reconfigs:
            if "devices" in ev:
                pool = [int(d) for d in ev["devices"]]
        if self.coordinator is not None and pool is not None:
            self.coordinator.restore_pool(pool)
        hb_lw = self.transport.low_water(HEARTBEAT_TOPIC)
        # never leave the cursor below the compacted low-water mark: if the
        # old holder compacted every beat and none arrived since, the first
        # pump() after failover would poll below low-water (a strict
        # transport raises) — flushed out by analysis.protocheck
        self._seen_beats = max(self._seen_beats, hb_lw)
        beats = sorted(self.transport.poll(HEARTBEAT_TOPIC, self._seen_beats),
                       key=lambda sp: sp[0])
        seen: Dict[int, int] = {}
        for seq, m in beats:
            self._seen_beats = max(self._seen_beats, seq + 1)
            w = int(m["worker"])
            seen[w] = max(seen.get(w, 0), int(m.get("ack", 0)))
        members = (sorted(self.coordinator.healthy)
                   if self.coordinator is not None else sorted(seen))
        for w in members:
            self.monitor.join(w)  # idempotent; fresh grace period
        self._acks = {w: a for w, a in seen.items() if w in self.monitor.last}
        info = {"pool": members, "replayed_beats": len(beats),
                "replayed_reconfigs": len(reconfigs)}
        self._log("coordinator_failover", **info)
        return info


class CoordinatorLease:
    """Coordinator election over the transport: an epoch-numbered,
    heartbeat-renewed lease record.

    The coordinator role must not die with worker 0 (co-hosting it there
    made it a single point of failure).  The lease lives on its own topic as
    append-only claim/renewal messages ``{"worker", "epoch"}``; no
    compare-and-swap is needed because the total order per topic plus a
    deterministic tie-break does the arbitration:

      - the *holder* is the worker of the highest epoch seen, with epoch
        ties broken toward the **lowest** worker id — two workers that
        claim the same epoch concurrently both observe both claims and
        converge on the lower id without coordination,
      - the holder republishes its claim every ``renew_every`` seconds; a
        lease not renewed for ``timeout`` is *stale*,
      - any worker that observes a stale (or absent) lease claims
        ``epoch + 1``.  A partitioned claimant's publish is dropped by the
        transport (returns -1), so it cannot win while unreachable.

    ``tick()`` drives the whole protocol and returns True while this
    worker holds the lease — the train loop gates ``pump()`` on it, and a
    worker that just acquired the lease must ``bootstrap_from_log()``
    before its first pump.  ``acquired`` flags that transition exactly
    once per acquisition.
    """

    def __init__(self, transport, worker_id: int, *, timeout: float = 5.0,
                 renew_every: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.transport = transport
        self.worker_id = worker_id
        self.timeout = timeout
        self.renew_every = renew_every if renew_every is not None \
            else timeout / 3.0
        self.clock = clock
        self.epoch = 0
        self.holder: Optional[int] = None
        self.acquired = False  # set by the tick that won the lease
        self._cursor = 0
        self._last_seen = clock()   # local receipt time of holder activity
        self._last_renew = -float("inf")

    def _consume(self) -> None:
        msgs = sorted(self.transport.poll(LEASE_TOPIC, self._cursor),
                      key=lambda sp: sp[0])
        for seq, m in msgs:
            if seq < self._cursor:
                continue
            self._cursor = seq + 1
            w, e = int(m["worker"]), int(m["epoch"])
            if e > self.epoch or self.holder is None:
                self.epoch, self.holder = e, w
                self._last_seen = self.clock()
            elif e == self.epoch:
                if w < self.holder:  # tie-break: lowest id wins the epoch
                    self.holder = w
                    self._last_seen = self.clock()
                elif w == self.holder:  # renewal
                    self._last_seen = self.clock()

    def stale(self) -> bool:
        return (self.holder is not None
                and self.clock() - self._last_seen >= self.timeout)

    def claim(self) -> None:
        """Publish a claim for the next epoch (used for seeding an initial
        holder deterministically in tests/harnesses; ``tick`` claims
        automatically once the lease goes stale).  Local state is NOT
        mutated here — adoption happens in ``_consume`` when the claim
        comes back through the log, so a dropped publish (partitioned
        endpoint) simply never wins."""
        self.transport.publish(
            LEASE_TOPIC, {"worker": self.worker_id, "epoch": self.epoch + 1}
        )
        self._last_renew = self.clock()

    def tick(self) -> bool:
        """Advance the protocol one step; True while this worker holds the
        lease (after consuming any competing claims)."""
        was_holder = self.holder == self.worker_id
        self._consume()
        now = self.clock()
        if self.holder == self.worker_id:
            if now - self._last_renew >= self.renew_every:
                self.transport.publish(
                    LEASE_TOPIC,
                    {"worker": self.worker_id, "epoch": self.epoch}
                )
                self._last_renew = now
            self.acquired = not was_holder
            return True
        if self.holder is None or now - self._last_seen >= self.timeout:
            self.claim()
            self._consume()  # a concurrent lower-id claim wins immediately
            if self.holder == self.worker_id:
                self.acquired = True
                return True
        self.acquired = False
        return False
