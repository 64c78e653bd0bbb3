"""Two-process torch.distributed harness: ``KVStoreTransport`` end to end.

The port of ``tests/multihost/run_two_proc.py``: the one place the port's
multi-host control plane runs against a real ``TCPStore`` shared by two
processes (a two-rank gloo group on localhost, CPU only) instead of the
in-process stores, with the reference harness's churn script and checks:

  process 0  owns virtual workers {0, 1, 2}.  It is the SURVIVOR: it beats
             its workers, watches the lease, and after the coordinator
             host dies it must win the election, bootstrap coordinator
             state from the topic log in the store, detect the dead
             workers, re-plan onto the exact non-pow2 survivor pool and
             re-carve a mesh.  It hosts the ``TCPStore`` (the store must
             outlive the kill, so the doomed process cannot host it).
  process 1  owns virtual workers {3, 4, 5, 6, 7} and first holds the
             coordinator lease (it seeds the first claim before process 0
             ticks).  Worker 7 never beats: the coordinator must detect
             that loss live over the store (churn 1); then worker 6 is
             silenced (churn 2); then the process ends itself with
             ``os._exit``, taking workers 3-5 and the coordinator role
             with it (churn 3, the failover).

Both transports are ``KVStoreTransport()`` over the default process
group's store.  The survivor's final re-carve cannot use the two-rank
group, since any collective of it would wait for the dead peer: it joins a
fresh one-rank group (a new prefix of the same store), re-carves through
``remesh_for_pool`` and the ``ExecutableCache``, and runs a small DTensor
computation on the carved mesh.

Run directly (exit code 0 = every check held)::

    python tests/_torch_two_proc.py

The clocks are the wall clock, as in the reference's harness: beats every
0.1 s, a 2 s heartbeat timeout and a 3 s lease.
"""
from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import tempfile
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

HB_TIMEOUT = 2.0      # monitor: silent worker declared dead after this
LEASE_TIMEOUT = 3.0   # lease: holder declared dead after this
BEAT_PERIOD = 0.1
NS = "mh-harness"
N_VIRTUAL = 8
P0_WORKERS = (0, 1, 2)
P1_WORKERS = (3, 4, 5, 6)   # worker 7 exists in the pool but never beats
DEADLINE = 90.0


def _log(role: int, msg: str) -> None:
    print(f"P{role} {msg}", flush=True)


def _store(role: int, port_file: str):
    """Process 0 hosts the store on a free port and writes the port down;
    process 1 reads it and connects."""
    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=DEADLINE)
    if role == 0:
        store = dist.TCPStore("localhost", 0, 2, True, timeout=timeout,
                              wait_for_workers=False)
        with open(port_file + ".tmp", "w") as f:
            f.write(str(store.port))
        os.replace(port_file + ".tmp", port_file)
        return store
    t0 = time.monotonic()
    while not os.path.exists(port_file):
        if time.monotonic() - t0 > DEADLINE:
            raise SystemExit("process 0 never wrote the store's port")
        time.sleep(0.05)
    with open(port_file) as f:
        port = int(f.read())
    return dist.TCPStore("localhost", port, 2, False, timeout=timeout)


def _init(role: int, port_file: str):
    import torch.distributed as dist

    from repro_torch.dist.transport import KVStoreTransport

    store = _store(role, port_file)
    dist.init_process_group("gloo", store=store, rank=role, world_size=2)
    return store, KVStoreTransport(NS, uid=f"p{role}")


def _fg_job():
    from repro_torch.configs.vgg16 import CONFIG as VCFG
    from repro_torch.core.coordinator import Job
    from repro_torch.models.graph import build_vgg_graph

    return Job("fg", "foreground", build_vgg_graph(VCFG, 32), amp_limit=1.5)


# ---------------------------------------------------------------------------
# process 1: first coordinator host — detects two losses, then dies hard
# ---------------------------------------------------------------------------


def run_coordinator(port_file: str) -> None:
    store, transport = _init(1, port_file)
    from repro_torch.core.coordinator import ClusterCoordinator
    from repro_torch.dist.faults import HeartbeatMonitor, MitigationLog
    from repro_torch.dist.transport import CoordinatorLease, CoordinatorLoop, WorkerClient

    coord = ClusterCoordinator(N_VIRTUAL, virtual_devices=True)
    coord.submit_foreground(_fg_job())
    monitor = HeartbeatMonitor(N_VIRTUAL, timeout=HB_TIMEOUT)
    cloop = CoordinatorLoop(transport, monitor, coordinator=coord, log=MitigationLog(),
                            gc_every=1)
    lease = CoordinatorLease(transport, worker_id=3, timeout=LEASE_TIMEOUT)
    lease.claim()  # seed the initial holder deterministically
    if not lease.tick():
        raise SystemExit("the seed claim must win")
    store.set("sync/lease-seeded", "1")
    workers = {w: WorkerClient(transport, w) for w in P1_WORKERS}
    silenced: set = set()
    replans = 0
    t0 = time.monotonic()
    while time.monotonic() - t0 < DEADLINE:
        for w in P1_WORKERS:
            if w not in silenced:
                workers[w].poll_reconfig()  # ack: reconfig GC can advance
                workers[w].beat(int((time.monotonic() - t0) / BEAT_PERIOD))
        if not lease.tick():
            raise SystemExit("nobody can contest a renewed lease")
        for ev in cloop.pump():
            replans += 1
            _log(1, f"REPLAN devices={ev['devices']}")
            if replans == 1:  # churn 1 handled (worker 7) -> silence worker 6
                silenced.add(6)
            elif replans == 2:
                # churn 2 handled (worker 6): die without any cleanup — no
                # group teardown, no lease release, no atexit
                _log(1, "DYING")
                os._exit(42)
        time.sleep(BEAT_PERIOD)
    raise SystemExit("coordinator never reached the kill point")


# ---------------------------------------------------------------------------
# process 0: the survivor — wins the lease, bootstraps, re-carves its mesh
# ---------------------------------------------------------------------------


def run_survivor(port_file: str) -> None:
    store, transport = _init(0, port_file)
    import torch
    import torch.distributed as dist

    from repro_torch.core.coordinator import ClusterCoordinator
    from repro_torch.core.multiplex import ExecutableCache
    from repro_torch.dist.faults import HeartbeatMonitor, MitigationLog
    from repro_torch.dist.transport import (
        HEARTBEAT_TOPIC,
        CoordinatorLease,
        CoordinatorLoop,
        WorkerClient,
    )
    from repro_torch.launch.mesh import remesh_for_pool

    store.wait(["sync/lease-seeded"], datetime.timedelta(seconds=DEADLINE))
    lease = CoordinatorLease(transport, worker_id=0, timeout=LEASE_TIMEOUT)
    workers = {w: WorkerClient(transport, w) for w in P0_WORKERS}
    cloop = None
    mlog = MitigationLog()
    pool = None
    failovers = 0
    t0 = time.monotonic()
    while time.monotonic() - t0 < DEADLINE:
        for w in P0_WORKERS:
            for ev in workers[w].poll_reconfig():
                if w == 0 and ev.get("action") == "replan":
                    pool = [int(d) for d in ev["devices"]]
                    _log(0, f"RECONFIG devices={pool}")
            workers[w].beat(int((time.monotonic() - t0) / BEAT_PERIOD))
        if lease.tick():
            if lease.acquired:
                # failover: fresh coordinator-side state, rebuilt from the
                # topic log (restore_pool adopts the dead holder's last
                # published pool; no mitigation re-fires for it)
                failovers += 1
                coord = ClusterCoordinator(N_VIRTUAL, virtual_devices=True)
                coord.submit_foreground(_fg_job())
                cloop = CoordinatorLoop(transport, HeartbeatMonitor(0, timeout=HB_TIMEOUT),
                                        coordinator=coord, log=mlog, gc_every=1)
                info = cloop.bootstrap_from_log()
                _log(0, f"FAILOVER epoch={lease.epoch} pool={info['pool']}")
            cloop.pump()
        if pool == [0, 1, 2]:
            break
        time.sleep(BEAT_PERIOD)
    # -- the acceptance checks ---------------------------------------------
    if failovers != 1:
        raise SystemExit(f"expected exactly one failover, got {failovers}")
    if pool != [0, 1, 2]:
        raise SystemExit(f"never re-planned to the survivor pool: {pool}")
    detected = sorted(e["worker"] for e in mlog.events if e["kind"] == "failure_detected")
    # workers 6 and 7 were handled by the old holder: detecting them again
    # would be a double-fired mitigation
    if detected != [3, 4, 5] or mlog.count("coordinator_failover") != 1:
        raise SystemExit(f"double-fired or missed: {detected}, {mlog.events}")
    lw = transport.low_water(HEARTBEAT_TOPIC)
    backlog = len(transport.poll(HEARTBEAT_TOPIC, lw))
    if lw == 0 or backlog > 64:
        raise SystemExit(f"heartbeat topic not compacted: low-water {lw}, backlog {backlog}")
    _log(0, f"GC lw={lw} backlog={backlog}")
    # the two-rank group waits for the dead peer in any collective: re-carve
    # over a fresh one-rank group on a new prefix of the same store
    dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.PrefixStore("survivor", store), rank=0,
                            world_size=1)
    cache = ExecutableCache()
    mesh = remesh_for_pool(pool)  # ids map positionally onto this group's one rank
    key = ExecutableCache.key("harness-step", mesh)

    def build():
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        def fn(x):
            return (distribute_tensor(x, mesh, [Shard(0), Replicate()]) * 2).sum().full_tensor()

        return fn

    fn = cache.get_or_build(key, build)
    if float(fn(torch.arange(12.0))) != 132.0 or cache.get_or_build(key, build) is not fn:
        raise SystemExit("the re-carved mesh's computation or its cache hit failed")
    _log(0, f"REMESH ranks={key[1]} shape={key[2]}")
    dist.destroy_process_group()
    _log(0, "HARNESS OK")


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def main() -> int:
    env = {**os.environ, "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    here = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        port_file = os.path.join(tmp, "store-port")
        procs = [subprocess.Popen([sys.executable, here, "--role", str(role), "--port-file",
                                   port_file], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for role in (0, 1)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=DEADLINE + 60)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            print("\n".join((p.communicate()[0] or "") for p in procs))
            print("TIMEOUT")
            return 1
    p0_out, p1_out = outs
    print(p1_out)
    print(p0_out)
    ok = True

    def check(cond: bool, what: str) -> None:
        nonlocal ok
        print(f"{'OK  ' if cond else 'FAIL'} {what}")
        ok &= cond

    check(procs[1].returncode == 42, "coordinator died via forced kill")
    check(procs[0].returncode == 0, "survivor exited clean")
    check("REPLAN devices=[0, 1, 2, 3, 4, 5, 6]" in p1_out,
          "churn 1: worker 7 detected over the store")
    check("REPLAN devices=[0, 1, 2, 3, 4, 5]" in p1_out,
          "churn 2: worker 6 detected, then forced kill")
    check("FAILOVER" in p0_out and "pool=[0, 1, 2, 3, 4, 5]" in p0_out,
          "survivor won the lease and adopted the dead holder's pool")
    check("RECONFIG devices=[0, 1, 2]" in p0_out,
          "churn 3: re-planned onto the exact non-pow2 survivor pool")
    check("REMESH ranks=(0,) shape=(1, 1)" in p0_out,
          "mesh re-carved over the survivor's fresh group")
    check("HARNESS OK" in p0_out, "all survivor-side checks held")
    print(f"two-process harness: {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", type=int, default=None)
    ap.add_argument("--port-file", default=None)
    args = ap.parse_args()
    if args.role is None:
        sys.exit(main())
    sys.path.insert(0, SRC)
    if args.role == 1:
        run_coordinator(args.port_file)
    else:
        run_survivor(args.port_file)
