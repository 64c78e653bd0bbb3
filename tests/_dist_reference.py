"""The reference's sharded steps on an Auto-axis mesh of forced host devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_dist_reference.py OUT_DIR CASES_JSON

Run by ``tests/test_torch_distributed.py`` in a subprocess of its own (the
device count is fixed when JAX starts).  The mesh is built with
``jax.sharding.Mesh`` over the devices, whose axes are Auto, so the
reference's ``fsdp`` constraints apply (``jax.make_mesh`` gives Explicit
axes, where they raise).  For each case it writes, under ``OUT_DIR``,
``<case>-in.npz`` (the initial parameters and the batch, which the port
loads) and ``<case>-out.npz`` (what the port must reproduce; JSON for the
collocation cases, ``tests/_colloc_cases.py``).
"""
import dataclasses
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.checkpoint.ckpt import _flatten
from repro.configs import TRAIN_4K, ShapeConfig, get_config
from repro.dist.sharding import sharding_rules
from repro.models import get_model
from repro.optim.optimizer import make_optimizer
from repro.train.state import init_state
from repro.train.step import jit_decode_step, jit_forward, jit_train_step

STEPS, LR_STEPS = 3, 5  # 3 steps of the cosine schedule over 5 (no warmup)
READ_ONLY = ("enc_k", "enc_v")  # the cache leaves a decode step reads and never writes


def make_mesh(shape):
    axes = ("pod", "data", "model")[-len(shape):]
    return Mesh(np.array(jax.devices()[: math.prod(shape)]).reshape(shape), axes)


def config(arch, over=None):
    """The reduced config in fp32, with a case's field overrides."""
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32", **(over or {}))


def rules_for(cfg, mesh, shape, case):
    """The cell's rules with a case's ``rules`` overrides (lists of mesh
    axes), or None where it has none (the step derives its own)."""
    if not case.get("rules"):
        return None
    return dict(sharding_rules(cfg, mesh, shape),
                **{k: tuple(v) for k, v in case["rules"].items()})


def batch_np(cfg, B, S, seed, uneven):
    """Seeded numpy batch; with ``uneven`` the first rows' labels are
    mostly -1, so each data shard holds a different count of them."""
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    if cfg.num_encoder_layers:
        S_dec = max(S // 4, 8)
        b = {"frames": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
             "tokens": rng.integers(0, V, (B, S_dec)).astype(np.int32),
             "labels": rng.integers(0, V, (B, S_dec)).astype(np.int32)}
    elif cfg.frontend == "vision":  # train_input_specs' length rule: S // 4 patches
        S_img = S // 4
        b = {"tokens": rng.integers(0, V, (B, S - S_img)).astype(np.int32),
             "labels": rng.integers(0, V, (B, S - S_img)).astype(np.int32),
             "patch_embeds": rng.standard_normal((B, S_img, cfg.d_model)).astype(np.float32)}
    else:
        b = {"tokens": rng.integers(0, V, (B, S)).astype(np.int32),
             "labels": rng.integers(0, V, (B, S)).astype(np.int32)}
    if uneven:
        lab = b["labels"]
        lab[0, :] = -1
        lab[1, 3:] = -1
        lab[B - 1, ::3] = -1
    return b


def run_train(name, case, out):
    cfg = config(case["arch"], case.get("cfg"))
    api, opt = get_model(cfg), make_optimizer(cfg, LR_STEPS)
    mesh = make_mesh(tuple(case["mesh"]))
    B, S = case.get("batch", 8), case.get("seq", 16)
    shape = dataclasses.replace(TRAIN_4K, seq_len=S, global_batch=B, name="t")
    fn, st_sh, bt_sh = jit_train_step(api, opt, mesh, shape, donate=False,
                                      rules=rules_for(cfg, mesh, shape, case))
    state0 = init_state(jax.random.PRNGKey(case.get("seed", 0)), api, opt)
    batch = batch_np(cfg, B, S, case.get("seed", 0) + 1, case.get("uneven", True))
    inputs = {"params/" + k: np.asarray(v) for k, v in _flatten(state0["params"]).items()}
    inputs.update({"batch/" + k: v for k, v in batch.items()})
    np.savez(os.path.join(out, f"{name}-in.npz"), **inputs)
    state = jax.device_put(state0, st_sh)
    b = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, bt_sh)
    losses, res = [], {}
    for i in range(STEPS):
        state, metrics = fn(state, b)
        losses.append(float(metrics["loss"]))
        if i == 0:  # the first step's moments: where the port's tolerance widens
            res.update({"first/" + k: np.asarray(v) for k, v in _flatten(state["opt"]).items()
                        if k.startswith("m/") or k.startswith("stats/")})
    res["losses"] = np.array(losses)
    res.update({"params/" + k: np.asarray(v) for k, v in _flatten(state["params"]).items()})
    opt_leaves = _flatten(state["opt"])
    res.update({"opt/" + k: np.asarray(v) for k, v in opt_leaves.items()
                if k.startswith("m/") or k.startswith("stats/")})
    if case.get("shards"):
        # every device's addressable shard of one leaf, by mesh coordinates
        leaf = _flatten(state0["params"])[case["shards"]]
        placed = jax.device_put(leaf, _flatten(st_sh["params"])[case["shards"]])
        coords = {d.id: idx for idx, d in np.ndenumerate(mesh.devices)}
        for sh in placed.addressable_shards:
            key = "-".join(map(str, coords[sh.device.id]))
            res[f"shard/{key}"] = np.asarray(sh.data)
    np.savez(os.path.join(out, f"{name}-out.npz"), **res)


def run_serve(name, case, out):
    """``jit_forward`` on a prefill batch (unless ``case["forward"]`` is
    false) and ``jit_decode_step`` with the rules' own decode layout (and
    the case's overrides) on a seeded cache of ``case["cap"]`` positions
    (32), once for each length of ``case["lens"]`` (each from the same
    seeded cache; the second's results under ``end/``).  Every cache leaf
    a decode step writes is saved; the encoder memory (``READ_ONLY``) is
    only read."""
    cfg = config(case["arch"], case.get("cfg"))
    api = get_model(cfg)
    mesh = make_mesh(tuple(case["mesh"]))
    B, S, cap = case.get("batch", 8), 16, case.get("cap", 32)
    params = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    prompt = batch_np(cfg, B, S, 6, uneven=False)
    prompt.pop("labels")
    token = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    cache = {k: rng.standard_normal(s.shape).astype(np.float32)
             for k, s in api.cache_schema(B, cap).items()}
    inputs = {"params/" + k: np.asarray(v) for k, v in _flatten(params).items()}
    inputs.update({"prompt/" + k: v for k, v in prompt.items()})
    inputs.update({"token": token})
    inputs.update({"cache/" + k: v for k, v in cache.items()})
    np.savez(os.path.join(out, f"{name}-in.npz"), **inputs)

    res = {}
    if case.get("forward", True):
        pshape = ShapeConfig("p", S, B, "prefill")
        fn, p_sh, bt_sh = jit_forward(api, mesh, pshape, rules=rules_for(cfg, mesh, pshape, case))
        res["logits"] = np.asarray(fn(jax.device_put(params, p_sh), jax.device_put(
            {k: jnp.asarray(v) for k, v in prompt.items()}, bt_sh)))
    dshape = ShapeConfig("d", cap, B, "decode")
    drules = rules_for(cfg, mesh, dshape, case)
    dfn, dp_sh, dbt_sh = jit_decode_step(api, mesh, dshape, donate=False, rules=drules)
    dparams = jax.device_put(params, dp_sh)
    for i, n in enumerate(case["lens"]):
        dbatch = {"token": jnp.asarray(token), "cache_len": jnp.int32(n),
                  "cache": {k: jnp.asarray(v) for k, v in cache.items()}}
        dlogits, new_cache = dfn(dparams, jax.device_put(dbatch, dbt_sh))
        pre = "end/" if i else ""
        res[pre + "decode_logits"] = np.asarray(dlogits)
        res.update({f"{pre}cache/{k}": np.asarray(v) for k, v in new_cache.items()
                    if k not in READ_ONLY})
    res["act_kv_seq"] = np.array(list((drules or sharding_rules(cfg, mesh, dshape))["act_kv_seq"])
                                 or [""])
    np.savez(os.path.join(out, f"{name}-out.npz"), **res)


def run_remesh(name, case, out):
    """``remesh_for_pool``'s carving of each pool: shape, device ids, axes."""
    from repro.launch.mesh import remesh_for_pool

    got = {}
    for key, pool in case["pools"].items():
        m = remesh_for_pool(pool)
        got[key] = {"shape": list(m.devices.shape), "ranks": [d.id for d in m.devices.flat],
                    "names": list(m.axis_names)}
    with open(os.path.join(out, f"{name}-out.json"), "w") as f:
        json.dump(got, f)


def _colloc():
    """The collocation scenarios' namespace over the reference's modules,
    and its plans by name."""
    from _colloc_cases import PLANS, scenario_namespace
    from repro.configs.vgg16 import CONFIG as VGG
    from repro.core import coordinator, costmodel, multiplex as mx, planner
    from repro.models import graph

    A100 = dataclasses.asdict(costmodel.A100)
    ns = scenario_namespace(coordinator=coordinator, mx=mx, costmodel=costmodel, graph=graph,
                            VGG=VGG, A100=A100)
    plans = {name: planner.plan(eval(expr, {"graph": graph, "VGG": VGG}), G, amp_limit=amp,
                                hw=costmodel.Hardware(**A100))
             for name, (expr, G, amp) in PLANS.items() if not name.startswith("llama")}
    return ns, plans


def run_exec(name, case, out):
    """``run_executable`` on the 8 devices under the scripted clock, cold
    and warm, for each ``(plan, roster, feedback)`` of ``case["cases"]``."""
    from _colloc_cases import exec_runs

    ns, plans = _colloc()
    got = [exec_runs(ns, plans[p], (p, r, fb)) for p, r, fb in case["cases"]]
    with open(os.path.join(out, f"{name}-out.json"), "w") as f:
        json.dump(got, f)


def run_coord(name, case, out):
    """The coordinator scenario in submesh mode on the 8 devices: admission,
    a failure of device 2 (a re-plan and re-carve over 7), the join."""
    ns, _ = _colloc()
    with open(os.path.join(out, f"{name}-out.json"), "w") as f:
        json.dump(ns["COORD"](same_device=False), f)


def run_engine(name, case, out):
    """``ServingEngine(mesh=, rules=)`` with the decode cell's rules: the
    tokens of ``generate``, then the prefill's logits and those of the
    last decode step of the same run by hand (``generate``'s loop)."""
    from repro.serve.engine import ServingEngine

    cfg = config(case["arch"], case.get("cfg"))
    api = get_model(cfg)
    mesh = make_mesh(tuple(case["mesh"]))
    B, cap, P, new = case["batch"], case["capacity"], case["prompt"], case["new"]
    params = api.init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(8).integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    rules = sharding_rules(cfg, mesh, ShapeConfig("d", cap, B, "decode"))
    eng = ServingEngine(cfg, params, B, cap, mesh, rules)
    tokens = eng.generate(prompts, new)
    eng.reset()
    logits = eng.prefill(prompts)
    res = {"tokens": tokens, "prefill_logits": np.asarray(logits)}
    tok = np.asarray(jnp.argmax(logits, axis=-1), np.int32)
    for _ in range(new - 1):
        logits, eng._cache = eng._decode(eng.params, jnp.asarray(tok[:, None]), eng._cache,
                                         eng._len)
        eng._len = eng._len + 1
        tok = np.asarray(jnp.argmax(logits, axis=-1), np.int32)
    res["last_logits"] = np.asarray(logits)
    res["act_kv_seq"] = np.array(list(rules["act_kv_seq"]) or [""])
    inputs = {"params/" + k: np.asarray(v) for k, v in _flatten(params).items()}
    np.savez(os.path.join(out, f"{name}-in.npz"), prompts=prompts, **inputs)
    np.savez(os.path.join(out, f"{name}-out.npz"), **res)


def run_disagg(name, case, out):
    """``ContinuousBatchingEngine(submeshes=split_mesh_for_serving(...))``
    over the 8 devices on a request trace: each request's tokens."""
    from repro.launch.mesh import split_mesh_for_serving
    from repro.serve.engine import ContinuousBatchingEngine
    from repro.serve.scheduler import ContinuousScheduler
    from repro.serve.trace import load_requests

    cfg = config(case["arch"])
    params = get_model(cfg).init(jax.random.PRNGKey(0))
    eng = ContinuousBatchingEngine(cfg, params, submeshes=split_mesh_for_serving(
        case["n_prefill"]), debug_checks=True, **case["engine"])
    rep = ContinuousScheduler(eng).run(load_requests(case["trace"]))
    inputs = {"params/" + k: np.asarray(v) for k, v in _flatten(params).items()}
    np.savez(os.path.join(out, f"{name}-in.npz"), **inputs)
    with open(os.path.join(out, f"{name}-out.json"), "w") as f:
        json.dump({"tokens": {str(r.rid): [int(t) for t in r.tokens] for r in rep.completed},
                   "used_pages": eng.alloc.used_pages}, f)


RUN = {"train": run_train, "serve": run_serve, "remesh": run_remesh, "exec": run_exec,
       "coord": run_coord, "engine": run_engine, "disagg": run_disagg}


def main():
    out, cases = sys.argv[1], json.loads(sys.argv[2])
    for name, case in cases.items():
        RUN[case["kind"]](name, case, out)
    print("DONE", len(cases))


if __name__ == "__main__":
    main()
