"""The port's sharded steps on gloo ranks of the CPU, one process per rank.

    python tests/_dist_ranks.py REF_DIR OUT_DIR MESH_JSON CASES_JSON

Run by ``tests/test_torch_distributed.py``: spawns one process per
position of the mesh (``MESH_JSON``, e.g. ``[4, 2]`` for (data, model) or
``[2, 2, 1]`` for (pod, data, model)), which meet through a file under
``OUT_DIR`` (no port).  Each rank runs every case of ``CASES_JSON`` on the
inputs ``tests/_dist_reference.py`` wrote to ``REF_DIR``; rank 0 writes
``<case>-port.npz`` (and, for a shard check, every rank its own shard).
Imports torch and ``repro_torch`` only.
"""
import dataclasses
import json
import math
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
STEPS, LR_STEPS = 3, 5
READ_ONLY = ("enc_k", "enc_v")  # the cache leaves a decode step reads and never writes


def _config(arch, over=None):
    """The reduced config in fp32, with a case's field overrides."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(), dtype="float32", **(over or {}))


def _rules(cfg, mesh, shape, case):
    """The cell's rules with a case's ``rules`` overrides, or None."""
    from repro_torch.dist.sharding import sharding_rules

    if not case.get("rules"):
        return None
    return dict(sharding_rules(cfg, mesh, shape),
                **{k: tuple(v) for k, v in case["rules"].items()})


def _mesh(shape):
    from repro_torch.launch.mesh import make_mesh

    if len(shape) == 3:
        return make_mesh(shape[1], shape[2], pod=shape[0])
    return make_mesh(*shape)


def _load(ref, name):
    with np.load(os.path.join(ref, f"{name}-in.npz")) as f:
        return {k: f[k] for k in f.files}


def _sub(flat, prefix):
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


def _full(tree, prefix):
    """Every DTensor leaf gathered (a collective: every rank calls it), as
    a copy (a replicated leaf's full tensor is its local one, which the
    next step updates in place)."""
    from repro_torch.checkpoint.ckpt import flatten

    return {prefix + k: (v.full_tensor() if hasattr(v, "full_tensor") else v).detach().numpy()
            .copy() for k, v in flatten(tree).items()}


def _batch(flat):
    return {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
            for k, v in _sub(flat, "batch/").items()}


def run_train(name, case, ref, out, rank):
    from repro_torch.checkpoint.ckpt import params_from_numpy
    from repro_torch.configs import TRAIN_4K
    from repro_torch.dist.sharding import device_put
    from repro_torch.models.api import get_model
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.train.step import jit_train_step

    cfg = _config(case["arch"], case.get("cfg"))
    api, opt = get_model(cfg), make_optimizer(cfg, LR_STEPS)
    mesh = _mesh(case["mesh"])
    flat = _load(ref, name)
    shape = dataclasses.replace(TRAIN_4K, seq_len=case.get("seq", 16),
                                global_batch=case.get("batch", 8), name="t")
    fn, st_sh, bt_sh = jit_train_step(api, opt, mesh, shape,
                                      rules=_rules(cfg, mesh, shape, case))
    params = params_from_numpy(_sub(flat, "params/"), device="cpu")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    state = device_put(state, st_sh)
    batch = device_put(_batch(flat), bt_sh)
    losses, res = [], {}
    for i in range(STEPS):
        state, metrics = fn(state, batch)
        losses.append(float(metrics["loss"]))
        if i == 0:  # the first step's moments: its gradients, scaled
            res.update({k: v for k, v in _full(state["opt"], "first/").items()
                        if k.startswith("first/m/") or k.startswith("first/stats/")})
    res["losses"] = np.array(losses)
    res.update(_full(state["params"], "params/"))
    res.update({k: v for k, v in _full(state["opt"], "opt/").items()
                if k.startswith("opt/m/") or k.startswith("opt/stats/")})
    res.update({f"placements/{k}": np.array([str(p) for p in sh.placements])
                for k, sh in bt_sh.items()})
    if case.get("shards"):
        from repro_torch.checkpoint.ckpt import flatten

        leaf = flatten(device_put(params, st_sh["params"]))[case["shards"]]
        coord = "-".join(map(str, mesh.get_coordinate()))
        np.save(os.path.join(out, f"{name}-shard-{coord}.npy"),
                leaf.to_local().detach().numpy())
    if case.get("ckpt"):
        from repro_torch.checkpoint import ckpt

        ckpt.save(os.path.join(out, case["ckpt"]), state, step=STEPS, async_=False)
    if rank == 0:
        np.savez(os.path.join(out, f"{name}-port.npz"), **res)


def run_serve(name, case, ref, out, rank):
    from repro_torch.checkpoint.ckpt import params_from_numpy
    from repro_torch.configs import ShapeConfig
    from repro_torch.dist.sharding import device_put
    from repro_torch.models.api import get_model
    from repro_torch.train.step import jit_decode_step, jit_forward

    cfg = _config(case["arch"], case.get("cfg"))
    api = get_model(cfg)
    mesh = _mesh(case["mesh"])
    flat = _load(ref, name)
    params = params_from_numpy(_sub(flat, "params/"), device="cpu")
    B, S, cap = case.get("batch", 8), 16, case.get("cap", 32)
    res = {}
    if case.get("forward", True):
        pshape = ShapeConfig("p", S, B, "prefill")
        fn, p_sh, bt_sh = jit_forward(api, mesh, pshape, rules=_rules(cfg, mesh, pshape, case))
        prompt = {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
                  for k, v in _sub(flat, "prompt/").items()}
        logits = fn(device_put(params, p_sh), device_put(prompt, bt_sh))
        res.update(logits=logits.full_tensor().numpy(),
                   logits_placements=np.array([str(p) for p in logits.placements]))
    dshape = ShapeConfig("d", cap, B, "decode")
    dfn, dp_sh, dbt_sh = jit_decode_step(api, mesh, dshape,
                                         rules=_rules(cfg, mesh, dshape, case))
    dparams = device_put(params, dp_sh)
    for i, n in enumerate(case["lens"]):
        dbatch = {"token": torch.as_tensor(flat["token"]).long(), "cache_len": int(n),
                  "cache": {k: torch.as_tensor(v) for k, v in _sub(flat, "cache/").items()}}
        dlogits, cache = dfn(dparams, device_put(dbatch, dbt_sh))
        pre = "end/" if i else ""
        res[pre + "decode_logits"] = dlogits.full_tensor().numpy()
        res.update(_full({k: v for k, v in cache.items() if k not in READ_ONLY},
                         pre + "cache/"))
    if rank == 0:
        np.savez(os.path.join(out, f"{name}-port.npz"), **res)


def run_restore(name, case, ref, out, rank):
    """The elastic restore: a checkpoint saved on one mesh, placed onto
    this one by its own shardings."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.dist.sharding import sharding_rules
    from repro_torch.models.api import get_model
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.train.state import abstract_state, state_shardings

    cfg = _config(case["arch"])
    api, opt = get_model(cfg), make_optimizer(cfg, LR_STEPS)
    mesh = _mesh(case["mesh"])
    sh = state_shardings(api, opt, sharding_rules(cfg, mesh), mesh)
    state, meta = ckpt.restore(os.path.join(out, case["ckpt"]), abstract_state(api, opt),
                               shardings=sh)
    res = _full(state["params"], "params/")
    leaf = state["params"]["layers"]["attn"]["wq"]
    res["placements"] = np.array([str(p) for p in leaf.placements])
    res["local_shape"] = np.array(leaf.to_local().shape)
    res["step"] = np.array(meta["step"])
    if rank == 0:
        np.savez(os.path.join(out, f"{name}-port.npz"), **res)


def run_layouts(name, case, ref, out, rank):
    """Each listed layout's step on this mesh must build; the outcomes are
    recorded ("builds", or the error).  ``case["layouts"]`` maps a name to
    ``[arch, kind, global batch, config overrides, rules overrides]``:
    ``train`` builds the train step, ``decode`` the decode step of a
    32-position cache (what each computes is held against the reference by
    the train and serve cases)."""
    from repro_torch.configs import TRAIN_4K, ShapeConfig
    from repro_torch.dist.sharding import sharding_rules
    from repro_torch.models.api import get_model
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.train.step import jit_decode_step, jit_train_step

    mesh = _mesh(case["mesh"])
    got = {}
    for key, (arch, kind, batch, cfg_over, rules_over) in case["layouts"].items():
        cfg = dataclasses.replace(_config(arch), **cfg_over)
        if kind == "train":
            shape = dataclasses.replace(TRAIN_4K, seq_len=16, global_batch=batch, name="t")
        else:
            shape = ShapeConfig("d", 32, batch, "decode")
        rules = dict(sharding_rules(cfg, mesh, shape), **{k: tuple(v)
                                                          for k, v in rules_over.items()})
        try:
            if kind == "train":
                jit_train_step(get_model(cfg), make_optimizer(cfg), mesh, shape, rules=rules)
            else:
                jit_decode_step(get_model(cfg), mesh, shape, rules=rules)
            got[key] = "builds"
        except Exception as e:  # recorded, so the test names it
            got[key] = f"{type(e).__name__}: {e}"
    if rank == 0:
        with open(os.path.join(out, f"{name}-port.json"), "w") as f:
            json.dump(got, f)


def run_bg_slice(name, case, ref, out, rank):
    """``bg_step_factory`` on a slice over every rank against the same
    factory on one CPU position."""
    from repro_torch.launch.mesh import rank_slice, submesh_from_range
    from repro_torch.train.step import bg_step_factory

    build = bg_step_factory(case["arch"], batch=8, seq=16, seed=2)
    sl = rank_slice(0, dist.get_world_size())
    step = build(sl)
    sharded = [float(step()) for _ in range(STEPS)]
    plain_step = build(submesh_from_range(0, 1, devices=[torch.device("cpu")]))
    plain = [float(plain_step()) for _ in range(STEPS)]
    if rank == 0:
        with open(os.path.join(out, f"{name}-port.json"), "w") as f:
            json.dump({"sharded": sharded, "plain": plain, "shape": list(sl.shape),
                       "mesh": list(sl.mesh.shape)}, f)


def run_remesh(name, case, ref, out, rank):
    from repro_torch.launch.mesh import remesh_for_pool

    got = {}
    for key, pool in case["pools"].items():
        m = remesh_for_pool(pool)
        got[key] = {"shape": list(m.shape), "ranks": m.mesh.flatten().tolist(),
                    "names": list(m.mesh_dim_names)}
    if rank == 0:
        with open(os.path.join(out, f"{name}-port.json"), "w") as f:
            json.dump(got, f)


def run_powersgd(name, case, ref, out, rank):
    """``powersgd_allreduce`` over the world: rank r holds the reference's
    gradient shard r and starts from its Q; ``case["iters"]`` rounds with
    error feedback, each rank saving its running mean of the results."""
    from repro_torch.optim.grad_compression import powersgd_allreduce

    flat = _load(ref, name)
    g = {"w": torch.as_tensor(flat["g_global"][rank])}
    state = {"w": {"q": torch.as_tensor(flat["q"]), "err": torch.zeros_like(g["w"])}}
    total = torch.zeros_like(g["w"])
    for _ in range(case["iters"]):
        approx, state = powersgd_allreduce(g, state, dist.group.WORLD, rank=case["rank"])
        total = total + approx["w"]
    np.save(os.path.join(out, f"{name}-avg-{rank}.npy"), (total / case["iters"]).numpy())


def primitive_collectives(world):
    """``(fn, args, expected)``: one call of each collective the port's
    steps issue, in-place (``torch.distributed``) and functional, on
    tensors of known sizes, and the operand bytes each kind must count: an
    all-gather's operand is this rank's piece, a reduce-scatter's the whole
    input, an all-to-all's its input, a broadcast's its tensor.  Every
    dtype and size differs, so a count taken from an output or of the
    wrong tensor differs from ``expected``."""
    import torch.distributed._functional_collectives as funcol

    group = dist.group.WORLD
    a = torch.ones(3, 5)                                # fp32: 60 bytes
    g = torch.ones(2, 7, dtype=torch.float64)           # 112; gathered: world x
    rs = torch.ones(world * 3, 4)                       # world x 48; scattered: 48
    x = torch.ones(world * 2, 3, dtype=torch.float16)   # world x 12
    b = torch.ones(5, dtype=torch.int64)                # 40

    def fn(a, g, rs, x, b):
        dist.all_reduce(a)
        dist.all_gather_into_tensor(g.new_empty(world * 2, 7), g)
        dist.all_gather([torch.empty_like(g) for _ in range(world)], g)
        dist.reduce_scatter_tensor(rs.new_empty(3, 4), rs)
        dist.all_to_all_single(torch.empty_like(x), x)
        dist.broadcast(b, 0)
        outs = [funcol.all_reduce(a, "sum", group), funcol.all_gather_tensor(g, 0, group),
                funcol.reduce_scatter_tensor(rs, "sum", 0, group)]
        return [funcol.wait_tensor(o) for o in outs]

    expected = {"all-reduce": 2 * 60, "all-gather": 3 * 112,
                "reduce-scatter": 2 * world * 48, "all-to-all": world * 12,
                "collective-permute": 40}
    return fn, (a, g, rs, x, b), expected


def run_collectives(name, case, ref, out, rank):
    """One train step of ``case["arch"]`` (fp32, 8 x 16) under
    ``launch.op_analysis.analyze_step``, then ``primitive_collectives``;
    rank 0 writes the collective bytes it counted, by kind, and the
    collective operator count of the step, and the primitives' bytes."""
    from repro_torch.configs import TRAIN_4K
    from repro_torch.dist.sharding import device_put
    from repro_torch.launch.op_analysis import analyze_step
    from repro_torch.models.api import get_model, make_batch
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.train.state import init_state
    from repro_torch.train.step import jit_train_step

    cfg = _config(case["arch"], case.get("cfg"))
    api, opt = get_model(cfg), make_optimizer(cfg)
    shape = dataclasses.replace(TRAIN_4K, seq_len=16, global_batch=8, name="t")
    fn, st_sh, bt_sh = jit_train_step(api, opt, _mesh(case["mesh"]), shape)
    gen = torch.Generator().manual_seed(0)
    state = device_put(init_state(api, opt, gen, "cpu"), st_sh)
    batch = device_put(make_batch(cfg, 8, 16, gen, "cpu"), bt_sh)
    costs = analyze_step(fn, state, batch)
    prim_fn, prim_args, _ = primitive_collectives(dist.get_world_size())
    prim = analyze_step(prim_fn, *prim_args)
    if rank == 0:
        with open(os.path.join(out, f"{name}-port.json"), "w") as f:
            json.dump({"collectives": costs.collectives,
                       "n_collective_ops": costs.diag.get("n_collective_ops", 0),
                       "primitives": prim.collectives, "world": dist.get_world_size()}, f)


def _colloc():
    """The collocation scenarios' namespace over the port's modules, and
    its plans by name (the reference's cost model)."""
    from _colloc_cases import PLANS, scenario_namespace
    from repro_torch.configs.vgg16 import CONFIG as VGG
    from repro_torch.core import coordinator, costmodel, multiplex as mx, planner
    from repro_torch.models import graph

    A100 = dataclasses.asdict(costmodel.A100)
    ns = scenario_namespace(coordinator=coordinator, mx=mx, costmodel=costmodel, graph=graph,
                            VGG=VGG, A100=A100)
    plans = {name: planner.plan(eval(expr, {"graph": graph, "VGG": VGG}), G, amp_limit=amp,
                                hw=costmodel.Hardware(**A100))
             for name, (expr, G, amp) in PLANS.items() if not name.startswith("llama")}
    return ns, plans


def _counting(ns, log):
    """The scenario's stage factory and a tenant wrapper that count each
    call of a built stage or step in ``log``, by the slice it was built
    on (its position ids and shape)."""
    def make_fg(stage, mesh):
        fn, key = ns["make_fg"](stage, mesh), json.dumps(["fg", stage.start, list(mesh.ids)])

        def call():
            log[key] = log.get(key, 0) + 1
            return fn()

        return call

    def wrap_tenant(t):
        def factory(mesh):
            fn = t.step_fn_factory(mesh)
            key = json.dumps(["bg", t.job, list(mesh.ids), list(mesh.shape)])

            def call():
                log[key] = log.get(key, 0) + 1
                return fn()

            return call

        factory.signature = t.step_fn_factory.signature
        return dataclasses.replace(t, step_fn_factory=factory)

    return make_fg, wrap_tenant


def run_exec(name, case, ref, out, rank):
    """``run_executable`` over rank slices of the whole world, cold and
    warm, for each case: every rank writes its results and the stage and
    step calls it issued, beside the calls of the same case on 8 CPU
    positions of this process that hold this rank (its share)."""
    from _colloc_cases import exec_runs

    ns, plans = _colloc()
    world = dist.get_world_size()
    got = []
    for p, r, fb in case["cases"]:
        issued, alone = {}, {}
        runs = exec_runs(ns, plans[p], (p, r, fb), *_counting(ns, issued), ranks=range(world))
        exec_runs(ns, plans[p], (p, r, fb), *_counting(ns, alone),
                  devices=[torch.device("cpu")] * world)
        share = {k: n for k, n in alone.items() if rank in json.loads(k)[2]}
        got.append({"runs": runs, "issued": issued, "share": share})
    with open(os.path.join(out, f"{name}-port-{rank}.json"), "w") as f:
        json.dump(got, f)


def run_coord(name, case, ref, out, rank):
    """The coordinator scenario in submesh mode, its positions the ranks."""
    from repro_torch.core import coordinator, multiplex as mx

    ns, _ = _colloc()
    with open(os.path.join(out, f"{name}-port-{rank}.json"), "w") as f:
        json.dump(ns["COORD"]((coordinator, mx), same_device=False), f)


def run_tp_tenant(name, case, ref, out, rank):
    """A tenant of quantum 2 on the widest gap slice the collocator carves
    for it over the ranks (a (k, 2) rank slice: tensor parallelism):
    ``case["steps"]`` steps on the slice's ranks, then on one CPU
    position of this process.  The tenant trains ``case["arch"]`` in fp32
    (registered as ``<arch>-fp32``), so the two agree to rounding."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import register
    from repro_torch.core import multiplex as mx
    from repro_torch.launch.mesh import submesh_from_range
    from repro_torch.train.step import bg_step_factory

    _, plans = _colloc()
    cfg = get_config(case["arch"])
    register(dataclasses.replace(cfg, name=f"{cfg.name}-fp32", dtype="float32"))
    build = bg_step_factory(f"{cfg.name}-fp32", batch=case["batch"], seq=16, seed=2)
    col = mx.Collocator(plans["vgg16@8"], mx.MultiplexConfig(),
                        tenants=[mx.BgTenant("tp", 1, build, quantum=2)],
                        ranks=range(dist.get_world_size()))
    slices = [e[1] for slots in col.submeshes().bg_tenants.values() for e in slots if e]
    sl = max(slices, key=lambda m: (m.size, -m.start))
    got = {"shape": list(sl.shape), "ranks": list(sl.ranks), "member": sl.member}
    if sl.member:
        step = build(sl)
        got["sharded"] = [float(step()) for _ in range(case["steps"])]
        plain = build(submesh_from_range(0, 1, devices=[torch.device("cpu")]))
        got["plain"] = [float(plain()) for _ in range(case["steps"])]
    with open(os.path.join(out, f"{name}-port-{rank}.json"), "w") as f:
        json.dump(got, f)


def _placed_as_the_rules_say(tree, shardings) -> bool:
    """Every leaf a DTensor on its sharding's mesh with its placements,
    holding the local shape those placements give."""
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.dist.sharding import mesh_axis_sizes

    leaves, shs = flatten(tree), flatten(shardings)
    ok = sorted(leaves) == sorted(shs)
    for k, x in leaves.items():
        sh = shs[k]
        sizes = mesh_axis_sizes(sh.mesh)
        want = list(x.shape)
        for d, e in enumerate(sh.spec):
            for a in ((e,) if isinstance(e, str) else e or ()):
                want[d] //= sizes[a]
        ok &= (tuple(x.placements) == tuple(sh.placements)
               and list(x.to_local().shape) == want)
    return bool(ok)


def run_engine(name, case, ref, out, rank):
    """``ServingEngine(mesh=, rules=)`` on the reference's weights and
    prompts: ``generate``'s tokens, then the prefill's logits and the last
    decode step's of the same run by hand; whether the cache sits where
    the rules say after the prefill and after the last step (every rank)."""
    from repro_torch.checkpoint.ckpt import params_from_numpy
    from repro_torch.configs import ShapeConfig
    from repro_torch.dist.sharding import param_shardings, sharding_rules
    from repro_torch.models.api import get_model
    from repro_torch.serve.engine import ServingEngine

    cfg = _config(case["arch"], case.get("cfg"))
    mesh = _mesh(case["mesh"])
    flat = _load(ref, name)
    params = params_from_numpy(_sub(flat, "params/"), device="cpu")
    B, cap, new = case["batch"], case["capacity"], case["new"]
    rules = sharding_rules(cfg, mesh, ShapeConfig("d", cap, B, "decode"))
    eng = ServingEngine(cfg, params, B, cap, device="cpu", mesh=mesh, rules=rules)
    res = {"tokens": eng.generate(flat["prompts"], new)}
    cache_sh = param_shardings(get_model(cfg).cache_schema(B, cap), rules, mesh)
    eng.reset()
    logits = eng.prefill(flat["prompts"])
    placed = [_placed_as_the_rules_say(eng._cache, cache_sh)]
    res["prefill_logits"] = logits.numpy()
    tok = logits.argmax(-1)
    for _ in range(new - 1):
        logits = eng._step(tok[:, None])
        eng._len += 1
        tok = logits.argmax(-1)
    placed.append(_placed_as_the_rules_say(eng._cache, cache_sh))
    res["last_logits"] = logits.numpy()
    with open(os.path.join(out, f"{name}-placed-{rank}.json"), "w") as f:
        json.dump(placed, f)
    if rank == 0:
        np.savez(os.path.join(out, f"{name}-port.npz"), **res)


def run_disagg(name, case, ref, out, rank):
    """``ContinuousBatchingEngine(submeshes=split_mesh_for_serving(...,
    ranks=))`` over the world on the reference's weights and trace: every
    rank writes each request's tokens, its handoffs and admits, and the
    pages still held."""
    from repro_torch.checkpoint.ckpt import params_from_numpy
    from repro_torch.launch.mesh import split_mesh_for_serving
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.scheduler import ContinuousScheduler
    from repro_torch.serve.trace import load_requests

    cfg = _config(case["arch"])
    params = params_from_numpy(_sub(_load(ref, name), "params/"), device="cpu")
    sm = split_mesh_for_serving(case["n_prefill"], ranks=range(dist.get_world_size()))
    eng = ContinuousBatchingEngine(cfg, params, submeshes=sm, debug_checks=True,
                                   device="cpu", **case["engine"])
    rep = ContinuousScheduler(eng).run(load_requests(case["trace"]))
    with open(os.path.join(out, f"{name}-port-{rank}.json"), "w") as f:
        json.dump({"tokens": {str(r.rid): [int(t) for t in r.tokens] for r in rep.completed},
                   "handoffs": len(eng.handoff_s), "prefills": eng.stats.prefills,
                   "decode_steps": eng.stats.decode_steps, "used_pages": eng.alloc.used_pages,
                   "roles": [eng.on_prefill, eng.on_decode],
                   "ranges": [list(sm.prefill_range), list(sm.decode_range)]}, f)


RUN = {"train": run_train, "powersgd": run_powersgd, "serve": run_serve, "restore": run_restore,
       "layouts": run_layouts, "bg_slice": run_bg_slice, "remesh": run_remesh,
       "collectives": run_collectives, "exec": run_exec, "coord": run_coord,
       "tp_tenant": run_tp_tenant, "engine": run_engine, "disagg": run_disagg}


def _rank(rank, world, ref, out, cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(out, "rendezvous"),
                            rank=rank, world_size=world)
    try:
        for name, case in cases.items():
            RUN[case["kind"]](name, case, ref, out, rank)
            dist.barrier()
    except Exception:
        with open(os.path.join(out, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def main():
    ref, out, shape, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), \
        json.loads(sys.argv[4])
    sys.path.insert(0, SRC)
    os.makedirs(out, exist_ok=True)
    world = math.prod(shape)
    mp.start_processes(_rank, args=(world, ref, out, cases), nprocs=world,
                       start_method="spawn")
    print("DONE", world)


if __name__ == "__main__":
    main()
