"""Executable-collocation scenarios that both packages run, as shared source.

Imported by ``tests/test_torch_collocation.py`` (the port on CPU positions
against the reference in a subprocess of 8 forced host devices) and by
the multi-rank harness (``tests/_dist_reference.py`` on 8 forced host
devices, ``tests/_dist_ranks.py`` on 8 gloo ranks).  ``SCRIPTED`` and
``COORD_SRC`` are source, executed in a namespace that names one
package's modules (``coordinator``, ``mx``, ``costmodel``, ``graph``,
``VGG``, ``A100``, ``as_json``): ``scenario_namespace`` builds one.
Imports neither package.
"""
import dataclasses
import json

PLANS = {  # name -> (graph expression in either package, devices, amp limit)
    "vgg16@8": ("graph.build_vgg_graph(VGG, 32)", 8, 1.5),
    "llama3-8b@8": ("graph.build_lm_graph(get_config('llama3-8b'), TRAIN_4K)", 8, 2.0),
    "vgg16@8-amp2": ("graph.build_vgg_graph(VGG, 32)", 8, 2.0),
    "inception@8": ("graph.build_inception_like_graph(32, n_blocks=3)", 8, 1.5),
}
ROSTERS = {  # name -> [(job, priority, signature, weight, quantum)]
    "two": [("jobA", 2, "A", 1.0, None), ("jobB", 1, "B", 1.0, None)],
    "mixed": [("hi", 2, "H", 1.0, 2), ("eq1", 1, "E1", 1.0, None),
              ("eq2", 1, "E2", 2.0, None)],
}
# the scripted clock and the plain-object stage and step functions, the same
# source in both packages
SCRIPTED = """
def make_clock():
    k, t = [0], [0.0]

    def time_fn():
        k[0] += 1
        t[0] += 1e-3 * (1 + (k[0] * 7919 % 13) / 8)
        return t[0]

    return time_fn


def make_fg(stage, mesh):
    return lambda: ("fg", stage.start)


def mk_factory(sig):
    def factory(mesh):
        return lambda: ("bg", sig)

    factory.signature = sig
    return factory


def roster(pkg_mx, name):
    return [pkg_mx.BgTenant(job, prio, mk_factory(sig), weight=w, quantum=q)
            for job, prio, sig, w, q in ROSTERS[name]]
"""
# the coordinator scenario, the same source in both packages: tenants with
# and without their own factory, a calibrated interference model that makes
# admission reject the marginal tenant, a failure of a low-index device, a
# bound that admits nobody; in GPU mode (every position one device) or, with
# ``same_device=False``, in submesh mode (8 devices, or 8 ranks)
COORD_SRC = """
def COORD(pkg=None, same_device=True, **kw):
    pkg = pkg or (coordinator, mx)
    pc, pm = pkg
    c = pc.ClusterCoordinator(8, costmodel.Hardware(**A100), clock=lambda: 0.0)
    c.submit_foreground(pc.Job("fg", "foreground", graph.build_vgg_graph(VGG, 32), 1.5))
    for name, prio, sig in (("bgA", 3, "A"), ("bgB", 2, "B"), ("bgC", 1, None), ("bgD", 1, "D")):
        c.submit_background(pc.Job(name, "background", [], priority=prio,
                                   step_fn_factory=mk_factory(sig) if sig else None))
    cfg = pm.MultiplexConfig(max_inflight=2, use_feedback=False,
                             collocate_same_device=same_device)
    rows = []

    def run(bound=1.33):
        r = c.collocate(cfg, executable=True, make_fg_stage_fn=make_fg,
                        make_bg_step_fn=mk_factory("default"), iterations=2,
                        admission_bound=bound, **kw)
        # the settled phase's length follows the monitor's wall-clock bans,
        # so only whether iterations ran, and what each launched, compare
        rows.append({
            "rejected": list(r.rejected_tenants), "ran": r.iterations > 0,
            "tenants": [[t.job, t.bg_steps_per_iter, list(t.gap_stages), t.devices]
                        for t in r.tenants],
            "bg_steps_per_iter": r.bg_steps_per_iter,
            "iter_steps": sorted({n for _, n in r.iter_details}),
            "cache": [r.cache_hits, r.cache_misses, c.exec_cache.hits, c.exec_cache.misses,
                      c.exec_cache.evictions, len(c.exec_cache)],
            "admission": c.last_admission.row() if c.last_admission else None,
        })
        return r

    run()
    c.interference = pm.InterferenceModel(gap_inflation=1.3, density_slope=0.8)
    run()
    c.handle_failure(2)
    run()
    c.handle_join([2])
    run()
    nobody = run(bound=1.0)
    rows.append(as_json(dataclasses.replace(nobody, banned_ops=())))  # bans: wall clock
    rows.append([[e.kind, e.detail] for e in c.events])
    return rows
"""


def plain(x):
    """Dataclasses of either package as (class name, fields), recursively,
    so the two packages' records compare with ``==`` (floats exactly)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


def as_json(x):
    """Records of either package in one comparable form (tuples as lists,
    dict keys as strings, floats exact)."""
    return json.loads(json.dumps(plain(x)))


def scenario_namespace(**modules) -> dict:
    """``SCRIPTED`` and ``COORD_SRC`` executed over ``modules`` (one
    package's ``coordinator``, ``mx``, ``costmodel``, ``graph``, ``VGG``,
    ``A100``)."""
    ns = dict(modules, ROSTERS=ROSTERS, as_json=as_json, dataclasses=dataclasses)
    exec(SCRIPTED, ns)
    exec(COORD_SRC, ns)
    return ns


def exec_runs(ns, plan, case, make_fg=None, wrap_tenant=None, **kw):
    """Cold then warm ``run_executable`` of one ``(plan, roster, feedback)``
    case under the scripted clock, sharing one ``ExecutableCache``: per
    run ``[result, bans, round]`` as JSON.  ``make_fg`` and
    ``wrap_tenant`` (a ``BgTenant`` -> ``BgTenant``) replace the stage
    factory and wrap each tenant; ``kw`` goes to the ``Collocator``."""
    pm = ns["mx"]
    _, rname, fb = case
    cfg = pm.MultiplexConfig(max_inflight=2, use_feedback=fb)
    cache = pm.ExecutableCache()
    out = []
    for _ in range(2):
        tenants = ns["roster"](pm, rname)
        if wrap_tenant is not None:
            tenants = [wrap_tenant(t) for t in tenants]
        col = pm.Collocator(plan, cfg, tenants=tenants, cache=cache, **kw)
        res = col.run_executable(make_fg or ns["make_fg"], iterations=2,
                                 time_fn=ns["make_clock"]())
        out.append([as_json(res), sorted(col.monitor.banned), col._round])
    return out
