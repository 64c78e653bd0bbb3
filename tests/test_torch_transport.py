"""The port's live control-plane transport (``repro_torch.dist.transport``,
``HeartbeatMonitor``) against the reference's, on the CPU.

Every scenario of ``tests/test_transport.py`` (the transport contract, the
GC contract, the protocol layer, the lease, the failover bootstrap and the
monitor's membership) runs from one script on the reference's objects and
on the port's.  Its assertions hold on each side, and the whole record it
returns must be equal: each topic's retained messages with their sequence
numbers, the low-water marks, the lease holder and epoch after each tick,
the ``MitigationLog`` events and the coordinator's pool.

The protocol scenarios run over each transport: ``InProcessBus``, the fake
pair, ``KVStoreTransport`` over the reference's dict-backed client (where
the port's keys and values must equal the reference's on the same script)
and, on the port's side only, over a real ``TCPStore`` in this process
(held to the reference over the dict client: the same sequence numbers,
and the same keys and values in the store).  Scripted clocks throughout.
"""
import datetime
import types

import pytest
import torch.distributed as dist

import repro.configs.vgg16 as ref_vgg
import repro.core.coordinator as ref_coordinator
import repro.dist.faults as ref_faults
import repro.dist.transport as ref_transport
import repro.models.graph as ref_graph
import repro_torch.configs.vgg16 as port_vgg
import repro_torch.core.coordinator as port_coordinator
import repro_torch.dist.faults as port_faults
import repro_torch.dist.transport as port_transport
import repro_torch.models.graph as port_graph


def _pkg(transport, faults, coordinator, graph, vgg):
    return types.SimpleNamespace(tr=transport, faults=faults, coordinator=coordinator,
                                 graph=graph.build_vgg_graph(vgg.CONFIG, 32))


REF = _pkg(ref_transport, ref_faults, ref_coordinator, ref_graph, ref_vgg)
PORT = _pkg(port_transport, port_faults, port_coordinator, port_graph, port_vgg)
TOPICS = ("hb", "reconfig", "lease")


class FakeKVClient:
    """Dict-backed client with the reference's surface: keys are write-once
    unless ``allow_overwrite`` is passed, deletion is explicit."""

    def __init__(self):
        self.store = {}

    def key_value_set(self, key, value, allow_overwrite=False):
        if key in self.store and not allow_overwrite:
            raise RuntimeError(f"Config key {key} already exists.")
        self.store[key] = value

    def key_value_delete(self, key):
        self.store.pop(key, None)

    def key_value_dir_get(self, prefix):
        return [(k, v) for k, v in self.store.items() if k.startswith(prefix)]


def tcp_store(timeout_s=2.0):
    return dist.TCPStore("localhost", 0, 1, True,
                         timeout=datetime.timedelta(seconds=timeout_s))


def store_contents(store, ns):
    """Every key of ``store`` under ``ns/`` with its value, as the dict
    client holds them."""
    keys = sorted(k for k in store.list_keys() if k.startswith(ns + "/"))
    return dict(zip(keys, (v.decode() for v in store.multi_get(keys)))) if keys else {}


class Ends:
    """A (worker end, coordinator end) pair of one transport kind over one
    store, and what the store holds."""

    def __init__(self, m, kind, ns="par"):
        self.ns = ns
        self.client = None
        if kind == "inprocess":
            bus = m.tr.InProcessBus()
            self.worker = self.coord = bus
        elif kind == "fake":
            self.worker, self.coord = m.tr.fake_transport_pair()
        else:
            # the reference has no TCPStore client: it runs over the dict
            self.client = tcp_store() if kind == "kv-tcp" and m is PORT else FakeKVClient()
            self.worker = m.tr.KVStoreTransport(ns, client=self.client, uid="host0-1")
            self.coord = m.tr.KVStoreTransport(ns, client=self.client, uid="host1-1")

    def contents(self):
        if self.client is None:
            return None
        if isinstance(self.client, FakeKVClient):
            return dict(sorted(self.client.store.items()))
        return store_contents(self.client, self.ns)

    def record(self):
        """Each topic's low-water mark and retained (seq, payload) messages,
        as the coordinator end sees them, and the raw store."""
        out = {t: (self.coord.low_water(t), self.coord.poll(t, self.coord.low_water(t)))
               for t in TOPICS}
        return out, self.contents()


def both(scenario, *args):
    """The scenario's record on the reference and on the port, equal."""
    want, got = scenario(REF, *args), scenario(PORT, *args)
    assert got == want
    return got


# ``kv-tcp``: the port over a TCPStore, the reference over the dict client
KINDS = ["inprocess", "fake", "kv-dict", "kv-tcp"]


# -- transport contract -----------------------------------------------------


def test_inprocess_bus_publish_poll_since():
    def scenario(m):
        bus = m.tr.InProcessBus()
        rec = [bus.poll("t"), bus.publish("t", {"a": 1}), bus.publish("t", {"a": 2}),
               bus.publish("other", {"b": 1})]
        msgs = bus.poll("t")
        assert msgs == [(0, {"a": 1}), (1, {"a": 2})] and bus.poll("t", since=2) == []
        bus.publish("t", {"a": 3})
        assert bus.poll("t", since=2) == [(2, {"a": 3})]
        assert bus.poll("t") == msgs + [(2, {"a": 3})]  # replay from 0 intact
        return rec + [bus.poll("t"), bus.poll("other")]

    both(scenario)


def test_fake_pair_shares_one_log_and_enforces_json():
    def scenario(m):
        w, c = m.tr.fake_transport_pair()
        w.publish("hb", {"worker": 0, "step": 1})
        with pytest.raises(TypeError):
            w.publish("hb", {"worker": object()})
        return c.poll("hb")

    assert both(scenario) == [(0, {"worker": 0, "step": 1})]


def test_fake_pair_disconnect_drops_publishes_silently():
    def scenario(m):
        w, c = m.tr.fake_transport_pair()
        rec = [w.publish("hb", {"worker": 0, "step": 1})]
        w.disconnect()
        rec += [w.publish("hb", {"worker": 0, "step": 2}), w.dropped, w.poll("hb"),
                c.poll("hb")]
        w.reconnect()
        rec += [w.publish("hb", {"worker": 0, "step": 3}), c.poll("hb")]
        return rec

    assert both(scenario) == [0, -1, 1, [], [(0, {"worker": 0, "step": 1})], 1,
                              [(0, {"worker": 0, "step": 1}), (1, {"worker": 0, "step": 3})]]


@pytest.mark.parametrize("kind", ["kv-dict", "kv-tcp"])
def test_kvstore_transport_round_trips_over_injected_client(kind):
    def scenario(m, kind):
        ends = Ends(m, kind, ns="test")
        a, b = ends.worker, ends.coord
        pubs = [a.publish("hb", {"worker": 0, "step": 1}), b.publish("hb", {"worker": 1, "step": 1}),
                a.publish("hb", {"worker": 0, "step": 2})]
        msgs = a.poll("hb")
        # lexicographic key order = (counter, uid): deterministic global order
        assert [p["worker"] for _s, p in msgs] == [0, 1, 0]
        assert [s for s, _p in msgs] == [0, 1, 2]
        assert b.poll("hb", since=2) == [(2, {"step": 2, "worker": 0})]
        assert a.poll("reconfig") == []  # topics are isolated namespaces
        return pubs, msgs, ends.contents()

    both(scenario, kind)


def test_kvstore_transport_requires_a_process_group():
    """No client and no process group: ``RuntimeError``, never the bus.
    With a group, the default store serves as the client, beside the
    group's own rendezvous keys."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="InProcessBus"):
        port_transport.KVStoreTransport("test")
    with pytest.raises(RuntimeError):
        ref_transport.KVStoreTransport("test")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        a = port_transport.KVStoreTransport("test", uid="a")
        b = port_transport.KVStoreTransport("test", uid="b")
        a.publish("hb", {"worker": 0})
        assert b.poll("hb") == [(0, {"worker": 0})]
        assert b.compact("hb", 1) == 1 and a.low_water("hb") == 1
    finally:
        dist.destroy_process_group()


def test_kvstore_poll_never_reads_a_missing_key():
    """A TCPStore's ``get`` on a missing key blocks until its timeout.
    Polls of empty topics, of compacted ones and of the low-water marks
    before any compaction list first and read only listed keys, so none
    waits out the 2 s timeout (a scripted count of the store's calls, not
    a clock)."""
    store = tcp_store(timeout_s=2.0)
    calls = []

    class Spy:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, name):
            fn = getattr(self.inner, name)

            def call(*args):
                out = fn(*args)
                calls.append((name, args, out))
                return out

            return call

    t = port_transport.KVStoreTransport("nb", client=port_transport.StoreKV(Spy(store)),
                                        uid="w")
    assert t.poll("hb") == [] and t.low_water("hb") == 0
    t.publish("hb", {"i": 0})
    t.publish("hb", {"i": 1})
    assert t.compact("hb", 1) == 1
    assert [p["i"] for _s, p in t.poll("hb", 1)] == [1] and t.low_water("hb") == 1
    listed = set()
    for name, args, out in calls:
        if name == "list_keys":
            listed = set(out)
        elif name == "multi_get":
            assert set(args[0]) <= listed, args
        elif name == "delete_key":
            listed.discard(args[0])
    assert not any(name == "get" for name, _, _ in calls)
    assert any(name == "multi_get" for name, _, _ in calls)


@pytest.mark.parametrize("kind", ["kv-dict", "kv-tcp"])
def test_kvstore_message_key_is_write_once(kind):
    """A second write to a message key is refused; the low-water key is the
    one written with ``allow_overwrite``."""
    client = tcp_store() if kind == "kv-tcp" else FakeKVClient()
    kv = port_transport.StoreKV(client) if kind == "kv-tcp" else client
    kv.key_value_set("ns/hb/000000000000.w", "{}")
    with pytest.raises(RuntimeError, match="already exists"):
        kv.key_value_set("ns/hb/000000000000.w", '{"again": 1}')
    kv.key_value_set("ns/.lw/hb", "1", allow_overwrite=True)
    kv.key_value_set("ns/.lw/hb", "2", allow_overwrite=True)
    assert kv.key_value_dir_get("ns/.lw/") == [("ns/.lw/hb", "2")]
    assert kv.key_value_dir_get("ns/hb/") == [("ns/hb/000000000000.w", "{}")]


def test_store_without_list_keys_is_refused():
    class OldStore:
        def set(self, key, value):
            pass

    with pytest.raises(RuntimeError, match="list_keys"):
        port_transport.KVStoreTransport("ns", client=OldStore())


# -- compaction / low-water GC contract --------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_compact_contract_parity(kind):
    def scenario(m, kind):
        ends = Ends(m, kind)
        a, b = ends.worker, ends.coord
        for i in range(6):
            a.publish("t", {"i": i})
        rec = [a.low_water("t"), a.compact("t", 4), a.low_water("t")]
        assert rec == [0, 4, 4]
        assert [(s, p["i"]) for s, p in a.poll("t", since=4)] == [(4, 4), (5, 5)]
        assert a.compact("t", 2) == 4   # monotone
        assert a.compact("t", 99) == 6  # clamped to the head
        assert a.poll("t", since=6) == []
        a.publish("t", {"i": 6})
        assert [(s, p["i"]) for s, p in a.poll("t", since=6)] == [(6, 6)]
        assert b.low_water("t") == 6
        assert [(s, p["i"]) for s, p in b.poll("t", since=b.low_water("t"))] == [(6, 6)]
        return rec, b.poll("t", 6), ends.contents()

    both(scenario, kind)


def test_fake_endpoint_asserts_no_read_below_low_water():
    def scenario(m):
        w, c = m.tr.fake_transport_pair()
        for i in range(4):
            w.publish("t", {"i": i})
        assert c.poll("t", since=0)
        c.compact("t", 3)
        for since in (1, 0):
            with pytest.raises(RuntimeError, match="low-water"):
                c.poll("t", since=since)
        return c.poll("t", since=c.low_water("t"))

    assert both(scenario) == [(3, {"i": 3})]


@pytest.mark.parametrize("kind", ["kv-dict", "kv-tcp"])
def test_kvstore_compact_preserves_lexicographic_order(kind):
    def scenario(m, kind):
        ends = Ends(m, kind, ns="gc")
        a, b = ends.worker, ends.coord
        a.publish("hb", {"w": 0, "n": 0})
        b.publish("hb", {"w": 1, "n": 0})
        a.publish("hb", {"w": 0, "n": 1})
        b.publish("hb", {"w": 1, "n": 1})
        order = [(p["w"], p["n"]) for _s, p in a.poll("hb")]
        assert order == [(0, 0), (1, 0), (0, 1), (1, 1)]
        assert a.compact("hb", 2) == 2
        left = sorted(k for k in ends.contents() if k.startswith("gc/hb/"))
        assert left == ["gc/hb/000000000001.host0-1", "gc/hb/000000000001.host1-1"]
        assert [(s, p["w"], p["n"]) for s, p in a.poll("hb")] == [(2, 0, 1), (3, 1, 1)]
        c = m.tr.KVStoreTransport("gc", client=ends.client, uid="host2-1")
        assert c.low_water("hb") == 2
        fresh = [(s, p["w"], p["n"]) for s, p in c.poll("hb", since=2)]
        assert fresh == [(2, 0, 1), (3, 1, 1)]
        return order, fresh, ends.contents()

    both(scenario, kind)


@pytest.mark.parametrize("kind", ["kv-dict", "kv-tcp"])
def test_kvstore_cursor_monotone_under_concurrent_publish(kind):
    def scenario(m, kind):
        ends = Ends(m, kind, ns="cc")
        fast, slow = ends.worker, ends.coord
        consumer = m.tr.KVStoreTransport("cc", client=ends.client, uid="host2-1")
        fast.publish("hb", {"m": "f0"})
        fast.publish("hb", {"m": "f1"})
        seen, cursor = {}, 0
        for seq, p in consumer.poll("hb", cursor):
            seen[seq] = p["m"]
            cursor = seq + 1
        assert seen == {0: "f0", 1: "f1"}
        slow.publish("hb", {"m": "s0"})
        slow.publish("hb", {"m": "s1"})
        for seq, p in consumer.poll("hb", cursor):
            assert seq not in seen, "re-read after renumbering"
            seen[seq] = p["m"]
            cursor = seq + 1
        assert sorted(seen.values()) == ["f0", "f1", "s0", "s1"] and cursor == 4
        fresh = m.tr.KVStoreTransport("cc", client=ends.client, uid="host3-1")
        assert [p["m"] for _s, p in fresh.poll("hb")] == ["f0", "s0", "f1", "s1"]
        return seen, fresh.poll("hb"), ends.contents()

    both(scenario, kind)


# -- protocol layer ---------------------------------------------------------


def _cluster(m, kind, n=8, timeout=5.0):
    """Coordinator + monitor + loop over one transport, scripted clock."""
    clk = {"t": 0.0}
    ends = Ends(m, kind)
    coord = m.coordinator.ClusterCoordinator(n, clock=lambda: clk["t"], virtual_devices=True)
    coord.submit_foreground(m.coordinator.Job("fg", "foreground", m.graph, amp_limit=1.5))
    mon = m.faults.HeartbeatMonitor(n, timeout=timeout, clock=lambda: clk["t"])
    loop = m.tr.CoordinatorLoop(ends.coord, mon, coordinator=coord, log=m.faults.MitigationLog())
    workers = [m.tr.WorkerClient(ends.worker, w) for w in range(n)]
    return clk, ends, coord, mon, loop, workers


def _state(ends, coord, loop):
    return (ends.record(), sorted(coord.healthy), coord.foreground().plan.num_gpus,
            loop.log.events, [(e.t, e.kind, e.detail) for e in coord.events])


@pytest.mark.parametrize("kind", KINDS)
def test_live_failure_detection_replans_exact_survivors(kind):
    def scenario(m, kind):
        clk, ends, coord, mon, loop, workers = _cluster(m, kind)
        assert coord.foreground().plan.num_gpus == 8
        for step in range(3):
            clk["t"] = float(step)
            for w in workers:
                w.beat(step)
            assert loop.pump() == []
        clk["t"] = 4.0
        for w in workers:
            if w.worker_id != 3:
                w.beat(3)
        assert loop.pump() == []  # age(3) = 2.0 < timeout
        clk["t"] = 7.5
        for w in workers:
            if w.worker_id != 3:
                w.beat(4)
        events = loop.pump()
        assert [(e["reason"], e["worker"], e["gpus"], e["devices"]) for e in events] == \
            [("failure", 3, 7, [0, 1, 2, 4, 5, 6, 7])]
        assert coord.healthy == {0, 1, 2, 4, 5, 6, 7}
        assert loop.log.count("failure_detected") == loop.log.count("replan") == 1
        clk["t"] = 20.0
        for w in workers:
            if w.worker_id != 3:
                w.beat(5)
        assert loop.pump() == [] and loop.log.count("failure_detected") == 1
        evs = workers[0].poll_reconfig()
        assert [e["action"] for e in evs] == ["replan"] and workers[0].poll_reconfig() == []
        return events, evs, _state(ends, coord, loop)

    both(scenario, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_unknown_beat_is_a_join_and_handle_join_is_idempotent(kind):
    def scenario(m, kind):
        clk, ends, coord, mon, loop, workers = _cluster(m, kind, n=7)
        assert coord.foreground().plan.num_gpus == 7
        m.tr.WorkerClient(ends.worker, 7).beat(0)
        events = loop.pump()
        assert mon.n_workers == 8 and 7 in mon.last
        assert coord.healthy == set(range(8)) and coord.foreground().plan.num_gpus == 8
        assert [e["reason"] for e in events] == ["join"] and loop.log.count("join") == 1
        n_events = len(coord.events)
        m.tr.WorkerClient(ends.worker, 7).beat(1)
        assert loop.pump() == [] and len(coord.events) == n_events
        assert coord.handle_join([2, 5]) is None and len(coord.events) == n_events
        return events, _state(ends, coord, loop)

    both(scenario, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_straggler_flagging_rearms_on_recovery(kind):
    def scenario(m, kind):
        clk, ends, coord, mon, loop, workers = _cluster(m, kind, n=4, timeout=100.0)
        counts = []
        for t, lag_step, front in ((0.0, 10, 10), (1.0, 2, 12), (2.0, 3, 13), (3.0, 14, 14),
                                   (4.0, 5, 15)):
            clk["t"] = t
            for w in workers:
                w.beat(lag_step if w.worker_id == 2 else front)
            loop.pump()
            counts.append(loop.log.count("straggler_worker"))
        assert counts == [0, 1, 1, 1, 2]  # flagged once, re-armed on recovery
        return _state(ends, coord, loop)

    both(scenario, kind)


def test_pump_orders_and_dedupes_adversarial_poll_batches():
    """Every poll re-delivers the whole retained history, reversed."""
    def scenario(m):
        class AdversarialBus(m.tr.InProcessBus):
            def poll(self, topic, since=0):
                return list(reversed(super().poll(topic, self.low_water(topic))))

        clk = {"t": 0.0}
        bus = AdversarialBus()
        coord = m.coordinator.ClusterCoordinator(8, clock=lambda: clk["t"],
                                                 virtual_devices=True)
        coord.submit_foreground(m.coordinator.Job("fg", "foreground", m.graph, amp_limit=1.5))
        mon = m.faults.HeartbeatMonitor(8, timeout=5.0, clock=lambda: clk["t"])
        loop = m.tr.CoordinatorLoop(bus, mon, coordinator=coord, log=m.faults.MitigationLog())
        workers = [m.tr.WorkerClient(bus, w) for w in range(8)]
        for step in range(3):
            clk["t"] = float(step)
            for w in workers:
                w.beat(step)
            assert loop.pump() == []
        clk["t"] = 7.5
        for w in workers:
            if w.worker_id != 3:
                w.beat(4)
        events = loop.pump()
        assert [e["worker"] for e in events] == [3]
        for t in (9.0, 11.0, 14.0):
            clk["t"] = t
            for w in workers:
                if w.worker_id != 3:
                    w.beat(int(t))
            assert loop.pump() == []
        assert loop.log.count("join") == 0
        assert loop.log.count("failure_detected") == loop.log.count("replan") == 1
        assert coord.foreground().plan.num_gpus == 7
        return events, loop.log.events, sorted(coord.healthy), bus.poll("hb")

    both(scenario)


# -- coordinator election (CoordinatorLease) --------------------------------


def _leases(m, n, timeout=6.0):
    clk = {"t": 0.0}
    bus = m.tr.InProcessBus()
    leases = [m.tr.CoordinatorLease(bus, w, timeout=timeout, clock=lambda: clk["t"])
              for w in range(n)]
    return clk, bus, leases


def _tick(lease, rec):
    """``lease.tick()``, recording the outcome, the holder and the epoch."""
    held = lease.tick()
    rec.append((lease.worker_id, held, lease.acquired, lease.holder, lease.epoch))
    return held


def test_lease_seed_claim_renewal_and_acquired_oneshot():
    def scenario(m):
        clk, bus, (l0, l1) = _leases(m, 2)
        rec = []
        l0.claim()
        assert _tick(l0, rec) and l0.acquired
        assert _tick(l0, rec) and not l0.acquired
        assert not _tick(l1, rec) and l1.holder == 0 and l1.epoch == 1
        clk["t"] = l0.renew_every + 0.01
        n_before = bus.backlog("lease")
        assert _tick(l0, rec) and bus.backlog("lease") == n_before + 1
        assert not _tick(l1, rec) and not l1.stale()
        return rec, bus.poll("lease")

    both(scenario)


def test_lease_stale_holder_superseded_via_tick_alone():
    def scenario(m):
        clk, bus, (l0, l1) = _leases(m, 2, timeout=6.0)
        rec = []
        l1.claim()
        assert _tick(l1, rec) and not _tick(l0, rec)
        clk["t"] = 3.0
        assert _tick(l1, rec) and not _tick(l0, rec)
        clk["t"] = 7.0
        assert not _tick(l0, rec)
        clk["t"] = 9.1
        assert _tick(l0, rec) and l0.acquired and (l0.epoch, l0.holder) == (2, 0)
        return rec, bus.poll("lease")

    both(scenario)


def test_lease_concurrent_claims_tiebreak_to_lowest_id():
    def scenario(m):
        clk, bus, leases = _leases(m, 3, timeout=6.0)
        l0, l1, l2 = leases
        rec = []
        l2.claim()
        for lease in leases:
            assert _tick(lease, rec) is (lease is l2)
        clk["t"] = 10.0
        l1.claim()
        l0.claim()
        assert not _tick(l1, rec)
        assert _tick(l0, rec) and l0.acquired
        assert l0.holder == l1.holder == 0 and l0.epoch == l1.epoch == 2
        clk["t"] = 10.5
        assert _tick(l0, rec) and not l0.acquired and not _tick(l1, rec)
        return rec, bus.poll("lease")

    both(scenario)


def test_lease_partitioned_claimant_cannot_win():
    def scenario(m):
        clk = {"t": 0.0}
        w_end, c_end = m.tr.fake_transport_pair()
        lw = m.tr.CoordinatorLease(w_end, 1, timeout=6.0, clock=lambda: clk["t"])
        lc = m.tr.CoordinatorLease(c_end, 0, timeout=6.0, clock=lambda: clk["t"])
        rec = []
        w_end.disconnect()
        assert not _tick(lw, rec) and lw.holder is None
        assert _tick(lc, rec) and lc.holder == 0
        w_end.reconnect()
        assert not _tick(lw, rec) and lw.holder == 0
        return rec, c_end.poll("lease")

    both(scenario)


# -- coordinator failover: bootstrap_from_log --------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_bootstrap_from_log_adopts_pool_without_refiring(kind):
    def scenario(m, kind):
        clk, ends, coord, mon, loop, workers = _cluster(m, kind)
        for step in range(3):
            clk["t"] = float(step)
            for w in workers:
                w.beat(step)
            loop.pump()
        clk["t"] = 7.5
        for w in workers:
            if w.worker_id != 3:
                w.beat(4)
        assert len(loop.pump()) == 1 and coord.foreground().plan.num_gpus == 7
        coord2 = m.coordinator.ClusterCoordinator(8, clock=lambda: clk["t"],
                                                  virtual_devices=True)
        coord2.submit_foreground(m.coordinator.Job("fg", "foreground", m.graph,
                                                   amp_limit=1.5))
        mon2 = m.faults.HeartbeatMonitor(0, timeout=5.0, clock=lambda: clk["t"])
        log2 = m.faults.MitigationLog()
        loop2 = m.tr.CoordinatorLoop(ends.coord, mon2, coordinator=coord2, log=log2)
        info = loop2.bootstrap_from_log()
        assert coord2.healthy == {0, 1, 2, 4, 5, 6, 7} and info["pool"] == [0, 1, 2, 4, 5, 6, 7]
        assert log2.count("coordinator_failover") == 1
        assert log2.count("failure_detected") == log2.count("replan") == 0
        clk["t"] = 8.0
        for w in workers:
            if w.worker_id != 3:
                w.beat(5)
        assert loop2.pump() == [] and log2.count("join") == 0
        clk["t"] = 14.0
        for w in workers:
            if w.worker_id not in (3, 5):
                w.beat(6)
        events = loop2.pump()
        assert [e["worker"] for e in events] == [5] and coord2.healthy == {0, 1, 2, 4, 6, 7}
        assert coord2.foreground().plan.num_gpus == 6 and log2.count("failure_detected") == 1
        return info, events, log2.events, _state(ends, coord2, loop2)

    both(scenario, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_gc_bounds_topics_and_keeps_pool_of_record(kind):
    def scenario(m, kind):
        clk, ends, coord, mon, loop, workers = _cluster(m, kind)
        loop.gc_every = 1
        for step in range(40):
            clk["t"] = float(step) * 0.5
            for w in workers:
                if w.worker_id == 3 and step >= 4:
                    continue  # worker 3 dies early in the run
                w.poll_reconfig()  # advance the ack the next beat carries
                w.beat(step)
            loop.pump()
        assert loop.log.count("failure_detected") == 1
        c = ends.coord

        def backlog(t):
            return len(c.poll(t, c.low_water(t)))

        assert backlog("hb") == 0 and c.low_water("hb") > 200
        assert backlog("reconfig") == 1  # the newest event retained
        coord2 = m.coordinator.ClusterCoordinator(8, clock=lambda: clk["t"],
                                                  virtual_devices=True)
        coord2.submit_foreground(m.coordinator.Job("fg", "foreground", m.graph,
                                                   amp_limit=1.5))
        loop2 = m.tr.CoordinatorLoop(c, m.faults.HeartbeatMonitor(0, timeout=5.0,
                                                                  clock=lambda: clk["t"]),
                                     coordinator=coord2, log=m.faults.MitigationLog())
        loop2.bootstrap_from_log()
        assert coord2.healthy == {0, 1, 2, 4, 5, 6, 7}
        assert coord2.foreground().plan.num_gpus == 7
        return _state(ends, coord, loop), loop2.log.events

    both(scenario, kind)


def test_monitor_join_forget_membership():
    def scenario(m):
        clk = {"t": 0.0}
        mon = m.faults.HeartbeatMonitor(2, timeout=5.0, clock=lambda: clk["t"])
        with pytest.raises(KeyError):
            mon.beat(5, 0)
        rec = [mon.join(5), mon.n_workers]
        mon.beat(5, 0)
        rec += [mon.join(5), mon.n_workers]
        clk["t"] = 10.0
        rec.append(mon.failed())
        rec += [mon.forget(5), mon.forget(5), mon.failed(), mon.n_workers, mon.stragglers()]
        return rec

    assert both(scenario) == [True, 3, False, 3, [0, 1, 5], True, False, [0, 1], 2, []]
