"""The port's executable gap multiplexing against the reference's, on the CPU.

The reference's carving and executable path need 8 devices, so they run
in one subprocess with ``--xla_force_host_platform_device_count=8`` (as
``tests/test_multiplex_diff.py`` does) that prints its results as JSON;
the port runs here on 8 positions of ``torch.device("cpu")``.

- ``split_mesh_for_plan`` on VGG-16@8 and llama3-8b@8 with 1-3 tenants and
  mixed quanta: the same ranges, slice shapes and errors.
- ``run_executable`` and ``run_iteration`` under a scripted clock
  (``time_fn`` advances a fixed, call-dependent amount per call) with stage
  and step functions that return plain Python objects, so the feedback
  loop sees the same times in both: every ``CollocationResult`` field
  equal (floats exactly), with feedback off and on, cold and warm cache.
- ``collocate(executable=True)``: admission, ``rejected_tenants``, the
  events, cache hits and misses and eviction across a failure, and the
  'fallback' event in submesh mode with too few devices.
- ``ServingAdmission`` and ``ContinuousScheduler(admission=...)`` on a
  fake engine: pure Python in both, so equal.
- ``train()`` with ``bg_step_fn``, ``bg_step_factory`` and the two CLIs.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs.vgg16 import CONFIG as REF_VGG
from repro.core import coordinator as ref_coord
from repro.core import costmodel as ref_costmodel
from repro.core import multiplex as ref_mx
from repro.models import graph as ref_graph
from repro.serve import scheduler as ref_sched
from repro.train.step import bg_step_factory as ref_bg_step_factory
from repro_torch.configs import TRAIN_4K, get_config
from repro_torch.configs.vgg16 import CONFIG as VGG
from repro_torch.core import coordinator, costmodel, multiplex as mx, planner
from repro_torch.launch import mesh
from repro_torch.models import graph
from repro_torch.models.api import get_model, make_batch
from repro_torch.optim.optimizer import make_optimizer
from repro_torch.serve import scheduler as sched
from repro_torch.train.loop import TrainConfig, train
from repro_torch.train.state import init_state
from repro_torch.train.step import bg_step_factory, make_train_step
from _colloc_cases import COORD_SRC, PLANS, ROSTERS, SCRIPTED, exec_runs
from test_torch_planner import plain

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU8 = [torch.device("cpu")] * 8
A100 = dataclasses.asdict(ref_costmodel.A100)

# -- the cases, shared with the reference script as literals (the plans, the
# rosters, the scripted clock and the coordinator scenario: tests/_colloc_cases.py)

CARVE_CASES = [  # (plan, tenants, tenant_quanta, fg_model, bg_model)
    (p, n, q, fm, bm)
    for p in ("vgg16@8", "llama3-8b@8")
    for n, q in ((1, None), (2, None), (3, None), (2, [2, 1]), (3, [1, 2, 4]), (3, [4]))
    for fm, bm in ((1, 1), (2, 1), (1, 2))
]
ERROR_CASES = [  # submesh_from_range arguments over 8 positions
    (3, 3, 1), (-1, 2, 1), (0, 9, 1), (0, 3, 2), (5, 4, 1),
]
EXEC_CASES = [(p, r, fb) for p in ("vgg16@8", "vgg16@8-amp2", "inception@8")
              for r in sorted(ROSTERS) for fb in (False, True)]

exec(SCRIPTED)  # defines make_clock, make_fg, mk_factory, roster here


def _as_json(x):
    """Records of either package in one comparable form (tuples as lists,
    dict keys as strings, floats exact), as the reference prints them."""
    return json.loads(json.dumps(plain(x)))


as_json = _as_json  # the name the shared coordinator scenario uses


def _monitor(m):
    return [m.baseline, m.ema, sorted(m.banned)]


def _port_plan(name, hw=None):
    expr, G, amp = PLANS[name]
    return planner.plan(eval(expr), G, amp_limit=amp, hw=hw or costmodel.Hardware(**A100))


def _split_record(split):
    rng = lambda s: [s.start, s.end, list(s.shape)]  # noqa: E731
    return {
        "fg_range": list(split.fg_range), "fg": rng(split.fg_mesh),
        "stage_fg_range": {str(k): list(v) for k, v in split.stage_fg_range.items()},
        "bg": {str(k): [list(r), rng(m)] for k, (r, m) in split.bg.items()},
        "bg_tenants": {str(k): [None if e is None else [list(e[0]), rng(e[1])] for e in v]
                       for k, v in split.bg_tenants.items()},
    }


REF_SCRIPT = SCRIPTED + """
import dataclasses, json
import jax
from repro.configs import TRAIN_4K, get_config
from repro.configs.vgg16 import CONFIG as VGG
from repro.core import coordinator, costmodel, multiplex as mx, planner
from repro.launch import mesh
from repro.models import graph

A100 = dataclasses.asdict(costmodel.A100)


def plain(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


def as_json(x):
    return json.loads(json.dumps(plain(x)))


def make_plan(name):
    expr, G, amp = PLANS[name]
    return planner.plan(eval(expr), G, amp_limit=amp, hw=costmodel.Hardware(**A100))


def split_record(split):
    rng = lambda m: [m.devices.flat[0].id, m.devices.flat[-1].id + 1, list(m.devices.shape)]
    return {
        "fg_range": list(split.fg_range), "fg": rng(split.fg_mesh),
        "stage_fg_range": {str(k): list(v) for k, v in split.stage_fg_range.items()},
        "bg": {str(k): [list(r), rng(m)] for k, (r, m) in split.bg.items()},
        "bg_tenants": {str(k): [None if e is None else [list(e[0]), rng(e[1])] for e in v]
                       for k, v in split.bg_tenants.items()},
    }


plans = {name: make_plan(name) for name in PLANS}
out = {"carve": [], "errors": [], "exec": [], "iteration": [], "coord": None}
for p, n, q, fm, bm in CARVE_CASES:
    try:
        rec = split_record(mesh.split_mesh_for_plan(
            plans[p], fg_model=fm, bg_model=bm, tenants=n, tenant_quanta=q))
    except ValueError as e:
        rec = {"error": str(e)}
    out["carve"].append(rec)
for args in ERROR_CASES:
    try:
        mesh.submesh_from_range(args[0], args[1], model=args[2])
        out["errors"].append(None)
    except ValueError as e:
        out["errors"].append(str(e))
try:
    mesh.split_mesh_for_plan(plans["vgg16@8"], devices=jax.devices()[:4])
except ValueError as e:
    out["short"] = str(e)


def exec_runs(case):
    _, rname, fb = case
    cfg = mx.MultiplexConfig(max_inflight=2, use_feedback=fb)
    cache = mx.ExecutableCache()
    res = []
    for _ in range(2):
        col = mx.Collocator(plans[case[0]], cfg, tenants=roster(mx, rname), cache=cache)
        r = col.run_executable(make_fg, iterations=2, time_fn=make_clock())
        res.append([as_json(r), sorted(col.monitor.banned), col._round])
    return res


for case in EXEC_CASES:
    out["exec"].append(exec_runs(case))
for name in ("vgg16@8", "inception@8"):
    col = mx.Collocator(plans[name], mx.MultiplexConfig(max_inflight=1))
    stages = [lambda i=i: ("fg", i) for i in range(len(plans[name].stages()))]
    r = col.run_iteration(stages, lambda: "bg", make_clock())
    m = col.monitor
    out["iteration"].append([r, [m.baseline, m.ema, sorted(m.banned)]])
out["coord"] = COORD()
print("RESULT " + json.dumps(out))
"""

exec(COORD_SRC)  # defines COORD here


@pytest.fixture(scope="module")
def ref():
    """The reference's results for every case, from one 8-device subprocess."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    consts = (f"PLANS = {PLANS!r}\nCARVE_CASES = {CARVE_CASES!r}\n"
              f"ERROR_CASES = {ERROR_CASES!r}\nROSTERS = {ROSTERS!r}\n"
              f"EXEC_CASES = {EXEC_CASES!r}\n")
    code = consts + textwrap.dedent(REF_SCRIPT).replace(
        'out["coord"] = COORD()', COORD_SRC + '\nout["coord"] = COORD()')
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def port_plans():
    return {name: _port_plan(name) for name in PLANS}


# -- the carving ------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(CARVE_CASES)),
                         ids=[f"{p}-n{n}-q{q}-fm{fm}-bm{bm}" for p, n, q, fm, bm in CARVE_CASES])
def test_split_mesh_for_plan_matches_reference(ref, port_plans, i):
    p, n, q, fm, bm = CARVE_CASES[i]
    try:
        got = _split_record(mesh.split_mesh_for_plan(
            port_plans[p], devices=CPU8, fg_model=fm, bg_model=bm, tenants=n,
            tenant_quanta=q))
    except ValueError as e:
        got = {"error": str(e)}
    assert got == ref["carve"][i]


def test_carving_errors_match_reference(ref, port_plans):
    got = []
    for start, end, model in ERROR_CASES:
        try:
            mesh.submesh_from_range(start, end, model=model, devices=CPU8)
            got.append(None)
        except ValueError as e:
            got.append(str(e))
    assert got == ref["errors"]
    assert all(got[:4])  # empty, below 0, past the end, not divisible
    with pytest.raises(ValueError) as e:
        mesh.split_mesh_for_plan(port_plans["vgg16@8"], devices=CPU8[:4])
    assert str(e.value) == ref["short"] == "plan wants 8 devices, process has 4"


@pytest.mark.parametrize("i", range(len(CARVE_CASES)),
                         ids=[f"{p}-n{n}-q{q}-fm{fm}-bm{bm}" for p, n, q, fm, bm in CARVE_CASES])
def test_rank_carving_matches_reference(ref, port_plans, i):
    """The same carving over the 8 ranks of a fake process group, played as
    rank 0, 3 and 7: the reference's ranges, shapes and errors; every slice
    a rank slice whose ranks are its positions, held by this rank exactly
    when one of them is."""
    p, n, q, fm, bm = CARVE_CASES[i]
    for rank in (0, 3, 7):
        with mesh.fake_world(8, "cpu", rank=rank):
            try:
                split = mesh.split_mesh_for_plan(port_plans[p], ranks=range(8), fg_model=fm,
                                                 bg_model=bm, tenants=n, tenant_quanta=q)
            except ValueError as e:
                assert {"error": str(e)} == ref["carve"][i]
                continue
            assert _split_record(split) == ref["carve"][i]
            slices = [split.fg_mesh] + [e[1] for v in split.bg_tenants.values() for e in v if e]
            for sl in slices:
                assert sl.ranks == sl.ids == tuple(range(sl.start, sl.end))
                assert sl.member == (rank in sl.ranks) and sl.mesh.shape == sl.shape


def test_rank_carving_errors_and_serving_split():
    """Over ranks, ``submesh_from_range`` raises the reference's errors
    (``ERROR_CASES``) and a short rank list the plan's; the serving split
    carves prefill [0, 2) and decode [2, 8) as rank slices; a slice carved
    again is the same mesh (no new communicators); ``fake_world`` refuses a
    rank outside its world."""
    with mesh.fake_world(8, "cpu", rank=5):
        got = []
        for start, end, model in ERROR_CASES:
            try:
                mesh.submesh_from_range(start, end, model=model, ranks=range(8))
                got.append(None)
            except ValueError as e:
                got.append(str(e))
        want = []
        for start, end, model in ERROR_CASES:
            try:
                mesh.submesh_from_range(start, end, model=model, devices=CPU8)
                want.append(None)
            except ValueError as e:
                want.append(str(e))
        assert got == want and all(got[:4])
        with pytest.raises(ValueError, match="plan wants 8 devices, process has 4"):
            mesh.split_mesh_for_plan(_port_plan("vgg16@8"), ranks=range(4))
        sm = mesh.split_mesh_for_serving(2, ranks=range(8))
        assert (sm.prefill_range, sm.decode_range) == ((0, 2), (2, 8)) and sm.disjoint()
        assert sm.prefill_mesh.ranks == (0, 1) and not sm.prefill_mesh.member
        assert sm.decode_mesh.ranks == tuple(range(2, 8)) and sm.decode_mesh.member
        again = mesh.submesh_from_range(2, 8, ranks=range(8))
        assert again.mesh is sm.decode_mesh.mesh
        assert mesh.rank_slice(0, 8, model=2).shape == (4, 2)
    with pytest.raises(ValueError, match="rank 8 outside a world of 8"):
        with mesh.fake_world(8, "cpu", rank=8):
            pass


def test_slices_take_devices_and_ids_by_position():
    devs = [torch.device("cuda", i) for i in range(4)]
    s = mesh.submesh_from_range(1, 3, devices=devs, ids=[10, 11, 12, 13])
    assert (s.start, s.end, s.size, s.shape, s.ids) == (1, 3, 2, (2, 1), (11, 12))
    assert s.devices == (torch.device("cuda", 1), torch.device("cuda", 2))
    one = mesh.submesh_from_range(4, 8, model=2, devices=CPU8)
    assert one.device == torch.device("cpu") and one.stream is None and one.ids == (4, 5, 6, 7)
    with pytest.raises(NotImplementedError, match="as the ranks of a process group"):
        s.device  # noqa: B018 — a step over two cards runs on a rank slice


# -- the executable path under a scripted clock --------------------------------


@pytest.mark.parametrize("i", range(len(EXEC_CASES)),
                         ids=[f"{p}-{r}-feedback{fb}" for p, r, fb in EXEC_CASES])
def test_run_executable_equals_reference(ref, port_plans, i):
    case = EXEC_CASES[i]
    got = exec_runs(globals(), port_plans[case[0]], case, devices=CPU8)
    want = ref["exec"][i]
    assert got == want
    (cold, _, _), (warm, _, _) = got
    assert cold[1]["iterations"] > 0 and warm[1]["cache_misses"] == 0
    if case[0].startswith("vgg16"):  # the inception's parallel branches fill its gap
        assert cold[1]["bg_steps_per_iter"] > 0 and cold[1]["cache_misses"] > 0
        assert warm[1]["cache_hits"] > 0


@pytest.mark.parametrize("i,name", enumerate(("vgg16@8", "inception@8")))
def test_run_iteration_equals_reference(ref, port_plans, i, name):
    col = mx.Collocator(port_plans[name], mx.MultiplexConfig(max_inflight=1))
    stages = [lambda i=i: ("fg", i) for i in range(len(port_plans[name].stages()))]
    r = col.run_iteration(stages, lambda: "bg", make_clock())
    assert json.loads(json.dumps([r, _monitor(col.monitor)])) == ref["iteration"][i]


def test_collocate_executable_matches_reference(ref):
    got = _as_json(COORD((coordinator, mx), device="cpu"))
    assert got == ref["coord"]
    first, calibrated = got[0], got[1]
    assert first["rejected"] == [] and len(first["tenants"]) == 4
    assert calibrated["rejected"]  # the marginal tenants are refused
    assert any(kind == "admission" for kind, _ in got[-1])
    assert not any(kind == "fallback" for kind, _ in got[-1])
    assert any(kind == "evict" for kind, _ in got[-1])


def test_collocate_falls_back_in_submesh_mode_with_too_few_devices():
    """The reference in this process sees one CPU device, the port in
    submesh mode on ``device="cpu"`` one too: both log the 'fallback'
    event and return the simulation."""
    out = []
    for pc, pm, kw in ((ref_coord, ref_mx, {}), (coordinator, mx, {"device": "cpu"})):
        hw = (costmodel if pc is coordinator else ref_costmodel).Hardware(**A100)
        c = pc.ClusterCoordinator(8, hw, clock=lambda: 0.0)
        g = (graph.build_vgg_graph(VGG, 32) if pc is coordinator
             else ref_graph.build_vgg_graph(REF_VGG, 32))
        c.submit_foreground(pc.Job("fg", "foreground", g, 1.5))
        res = c.collocate(pm.MultiplexConfig(), executable=True, make_fg_stage_fn=make_fg,
                          make_bg_step_fn=mk_factory("x"), **kw)
        out.append((plain(res), [(e.kind, e.detail) for e in c.events]))
    assert out[0] == out[1]
    assert out[1][1] == [("fallback", "executable collocation wants 8 devices, process has "
                          "1 healthy -> MultiplexSim")]


def test_gpu_mode_defaults_to_the_card_at_every_position(monkeypatch, port_plans):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    col = mx.Collocator(port_plans["vgg16@8"], mx.MultiplexConfig(collocate_same_device=True))
    assert col._device_list() == [torch.device("cuda", 0)] * 8
    split = col.submeshes(tenants=2)
    chunks = [e[0] for v in split.bg_tenants.values() for e in v if e is not None]
    assert chunks and all(e[1].device == torch.device("cuda", 0)
                          for v in split.bg_tenants.values() for e in v if e is not None)


def test_block_and_future_done_semantics():
    t = torch.ones(2)
    assert mx._block(t) is t and mx._future_done(t)
    obj = ("bg", 1)
    assert mx._block(obj) is obj and not mx._future_done(obj)
    assert mx._issue(lambda: obj, None) is obj
    meta = torch.empty(2, device="meta")  # any non-CPU tensor without its event
    with pytest.raises(ValueError, match="without the torch.cuda.Event"):
        mx._block(meta)


def test_cache_keys_positions_not_devices():
    """On one card every position is the same device: the key must keep
    two chunks apart, and predicted keys must equal the built ones."""
    a = mesh.submesh_from_range(0, 2, devices=CPU8)
    b = mesh.submesh_from_range(2, 4, devices=CPU8)
    assert mx.ExecutableCache.key("s", a) != mx.ExecutableCache.key("s", b)
    assert mx.ExecutableCache.key("s", b) == ("s", (2, 3), (2, 1))


# -- serving admission --------------------------------------------------------

ADMISSION_GRID = [  # (n_devices, n_prefill, prefill, decode step, slo, gap_inflation, slope)
    (8, 4, 10e-3, 1e-3, 12.4e-3, 1.2, 0.5),
    (8, 4, 10e-3, 1e-3, 100e-3, 1.0, 0.0),
    (8, 4, 10e-3, 1e-3, 10.5e-3, 1.5, 1.0),
    (5, 1, 35e-3, 99e-3, 52.5e-3, 1.0, 0.0),
    (16, 2, 4e-3, 0.3e-3, 5e-3, 1.1, 2.0),
    (3, 2, 1.0, 2.0, 1.9, 1.4, 0.0),
]


@pytest.mark.parametrize("case", ADMISSION_GRID, ids=lambda c: "-".join(map(str, c)))
def test_serving_admission_max_concurrent(case):
    n, npf, pt, dt, slo, gi, ds = case
    got, want = [], []
    for pkg_sched, pkg_mx, out in ((sched, mx, got), (ref_sched, ref_mx, want)):
        adm = pkg_sched.ServingAdmission(
            n, npf, prefill_time=pt, decode_step_time=dt, ttft_slo=slo,
            interference=pkg_mx.InterferenceModel(gap_inflation=gi, density_slope=ds))
        out.append(adm.bound)
        out += [plain(adm.max_concurrent(k)) for k in range(7)]
    assert got == want


def test_fit_interference_matches_reference():
    iso = 10e-3
    for samples in ([(1.0, 13e-3), (2.0, 17e-3), (3.0, 21.5e-3)], [(1.0, 9e-3)],
                    [(2.0, 15e-3)], [(1.0, 12e-3), (4.0, 30e-3), (1.0, 14e-3)]):
        assert (plain(sched.ServingAdmission.fit_interference(iso, samples))
                == plain(ref_sched.ServingAdmission.fit_interference(iso, samples)))
    with pytest.raises(ValueError, match="below the isolated prefill"):
        sched.ServingAdmission(8, 4, prefill_time=1.0, decode_step_time=0.1, ttft_slo=0.5)


class FakeEngine:
    """The engine contract at no cost: ``lanes`` lanes, ``pages`` pages of
    one token, each tick gives every live request one token."""

    def __init__(self, lanes, pages):
        self.lanes, self.pages = lanes, pages
        self.live = []
        self.stats = None

    def has_free_lane(self):
        return len(self.live) < self.lanes

    def live_count(self):
        return len(self.live)

    def can_fit(self, req, check=False):
        return req.total_tokens <= self.pages

    def admit(self, req):
        if req.total_tokens > self.pages - sum(r.total_tokens for r in self.live):
            return False
        req.tokens.append(1)
        self.live.append(req)
        return True

    def retire(self, req):
        self.live.remove(req)

    def step(self):
        for r in self.live:
            r.tokens.append(len(r.tokens) + 1)
        done = [r for r in self.live if r.decoding_done()]
        for r in done:
            self.retire(r)
        return done


@pytest.mark.parametrize("arrivals", ["together", "spaced"])
@pytest.mark.parametrize("case", [ADMISSION_GRID[0], ADMISSION_GRID[2], ADMISSION_GRID[3],
                                  None], ids=["tight", "fg-only", "one-card", "none"])
def test_scheduler_admission_deferrals(case, arrivals):
    rng = np.random.default_rng(5)
    reqs = [(f"r{i}", rng.integers(0, 50, 1 + i % 4), 2 + i % 3,
             0.0 if arrivals == "together" else 1.0 * i) for i in range(9)]
    out = []
    for pkg_sched, pkg_mx in ((sched, mx), (ref_sched, ref_mx)):
        adm = None
        if case is not None:
            n, npf, pt, dt, slo, gi, ds = case
            adm = pkg_sched.ServingAdmission(
                n, npf, prefill_time=pt, decode_step_time=dt, ttft_slo=slo,
                interference=pkg_mx.InterferenceModel(gap_inflation=gi, density_slope=ds))
        eng = FakeEngine(lanes=3, pages=16)
        s = pkg_sched.ContinuousScheduler(eng, admission=adm, clock=pkg_sched.VirtualClock())
        rep = s.run([pkg_sched.Request(rid, p, m, arrival=a) for rid, p, m, a in reqs])
        out.append((rep.admission_deferrals, rep.page_deferrals,
                    [(r.rid, list(r.tokens)) for r in rep.completed],
                    plain(s.last_decision)))
    assert out[0] == out[1]
    assert len(out[0][2]) == len(reqs)


# -- the train loop's background tenants --------------------------------------


def _fg_cfg():
    return get_config("qwen2-1.5b").reduced()


def _shape():
    return dataclasses.replace(TRAIN_4K, seq_len=16, global_batch=2, name="t")


def test_train_with_bg_tenants_keeps_fg_losses():
    cfg = _fg_cfg()
    alone = train(cfg, _shape(), TrainConfig(steps=3), device="cpu")
    losses = []
    tenant = bg_step_factory("minicpm-2b", seq=8, seed=2, on_loss=losses.append,
                             per_device_batch=2)(mesh.submesh_from_range(0, 1, devices=CPU8))
    tc = TrainConfig(steps=3, bg_step_fn=tenant,
                     multiplex=mx.MultiplexConfig(max_inflight=3))
    rep = train(cfg, _shape(), tc, device="cpu")
    assert rep.losses == alone.losses  # the tenants leave the foreground bit-identical
    assert rep.bg_steps == 3 * 3 == len(losses)
    assert alone.bg_steps == 0
    assert np.isfinite([float(x) for x in losses]).all()


@pytest.mark.parametrize("pdb,width", [(None, 3), (2, 1), (2, 3)])
def test_bg_step_factory_equals_make_train_step(pdb, width):
    factory = bg_step_factory("qwen2-1.5b", batch=3, seq=8, seed=4, per_device_batch=pdb)
    step = factory(mesh.submesh_from_range(2, 2 + width, devices=CPU8))
    cfg = get_config("qwen2-1.5b").reduced()
    api = get_model(cfg)
    opt = make_optimizer(cfg)
    want_step = make_train_step(api, opt)
    state = init_state(api, opt, torch.Generator().manual_seed(4), "cpu")
    b = 3 if pdb is None else pdb * width
    batch = make_batch(cfg, b, 8, torch.Generator().manual_seed(5), "cpu")
    for _ in range(2):
        got = step()
        state, metrics = want_step(state, batch)
        assert torch.equal(got, metrics["loss"])
    assert batch["tokens"].shape == (b, 8)


def test_bg_step_factory_signatures_match_reference():
    for kw in (dict(), dict(batch=2, seq=32, seed=1), dict(seq=8, seed=0, per_device_batch=2),
               dict(seq=32, seed=3, per_device_batch=4)):
        for arch in ("qwen2-1.5b", "minicpm-2b"):
            assert (bg_step_factory(arch, **kw).signature
                    == ref_bg_step_factory(arch, **kw).signature)


def test_bg_step_over_two_cards_raises_with_its_roadmap_item():
    two = mesh.submesh_from_range(0, 2, devices=[torch.device("cuda", 0),
                                                 torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError, match="as the ranks of a process group"):
        bg_step_factory("qwen2-1.5b")(two)


# -- the CLIs -----------------------------------------------------------------


def test_train_cli_with_bg_archs(capsys):
    from repro_torch.launch import train as cli

    cli.main(["--arch", "qwen2-1.5b", "--bg-arch", "qwen2-1.5b", "--bg-arch", "minicpm-2b",
              "--steps", "3", "--batch", "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    warning = ("WARNING: no gap submesh for bg tenant(s) 0 (qwen2-1.5b), 1 (minicpm-2b) — "
               "the plan's gaps packed only 0 chunk(s); dropped tenants fall back to "
               "same-device jit (they share the fg devices instead of a disjoint submesh)")
    assert warning in out
    assert out.index(warning) < len(out) - 1
    assert "bg tenant 0 (qwen2-1.5b) same-device fallback" in out
    assert "bg tenant 1 (minicpm-2b) same-device fallback" in out
    assert out[-1].startswith("done on cpu: steps=3 ") and out[-1].endswith(" bg_steps=6")


def test_multiplex_demo_cli(capsys):
    from repro_torch.launch import multiplex_demo

    col, res, pred, losses = multiplex_demo.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "admission: admitted 2/2" in out
    assert [t.job for t in res.tenants] == ["bg-hi", "bg-lo"]
    for t in res.tenants:
        assert f"  {t.row()} (weight 1, deficit 0.0)" in out
    assert res.iterations > 0 and res.bg_steps_per_iter > 0
    assert len(losses) > 0 and np.isfinite([float(x) for x in losses]).all()
    assert "calibrated gap_inflation=" in out and "predict fg_slowdown=" in out
