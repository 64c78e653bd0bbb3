"""The port's sharded steps against the reference's sharded steps, on the CPU.

The reference runs once, in a subprocess with 8 forced host devices
(``tests/_dist_reference.py``), on meshes built with
``jax.sharding.Mesh`` (Auto axes, where its ``fsdp`` constraints apply).
It writes each case's initial parameters and batch, which the port loads
through ``checkpoint.ckpt.params_from_numpy``, and its results.  The port
runs the same cases on spawned gloo ranks, one spawn per mesh shape
(``tests/_dist_ranks.py``), meeting through a file under the test's
temporary directory.

Tolerances (fp32): losses to 1e-5 relative; parameters after 3 steps to a
tenth of the first step's learning rate, except elements whose gradient
cancels to rounding noise (the reference's first moment, or Adafactor's
unfactored second moment, below ``NOISE_FLOOR`` of the leaf's largest
after the first step or the last:
Adam's and Adafactor's normalised steps move those by up to ``lr`` in the
sign of the noise), held to ``2 lr`` a step; moments to 1e-5 (absolute
and relative, as ``tests/test_torch_train.py`` holds one step); forward
and decode logits and the written cache to 1e-5 of the largest
magnitude.  The decode cases run the rules' own decode layout, so where
the cache is split along its sequence (``act_kv_seq``) both sides decode
it split.

The (4, 2) spawn also runs the plan carving over ranks: the reference's
``run_executable`` and ``collocate(executable=True)`` in submesh mode on
its 8 devices against the port's on 8 ranks (``tests/_colloc_cases.py``'s
scripted clock and coordinator scenario: every rank's results equal, and
each rank issued exactly its share), a quantum-2 tenant on a
tensor-parallel rank slice, ``ServingEngine(mesh=, rules=)`` and
``ContinuousBatchingEngine`` over ``split_mesh_for_serving(2, ranks=)``.

The same spawn holds every layout the rules and their overrides give
beyond the defaults against the reference, each case carrying its config
and rules overrides to both sides (``TRAIN_LAYOUTS``, ``SERVE_LAYOUTS``,
``ENGINE_OVERRIDES``): sequence parallelism over 'model' for every family,
KV heads split with the query heads whole, Mamba-2's ``d_inner`` split
over whole heads, parameters split on 'model' along ``norm`` or ``embed``,
a cache the divisibility guard keeps whole, and the MoE engine routing a
step as one group over the whole batch.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
LR, STEPS = 3e-4, 3
LOSS_TOL = 1e-5
PARAM_ATOL = 0.1 * LR
MOMENT_TOL = 1e-5
NOISE_FLOOR = 1e-4
OUT_TOL = 1e-5

TRAIN = {  # case -> (arch, mesh)
    "llama-4x2": ("llama3-8b", [4, 2]),
    "rwkv-4x2": ("rwkv6-1.6b", [4, 2]),
    "zamba-4x2": ("zamba2-2.7b", [4, 2]),
    "moe-4x2": ("qwen3-moe-30b-a3b", [4, 2]),  # expert parallelism: 4 experts over 2
    "grok-4x2": ("grok-1-314b", [4, 2]),  # tensor-parallel experts: moe_d_ff 64 over 2
    "pixtral-4x2": ("pixtral-12b", [4, 2]),  # frontend_proj on embed_out, with patches
    "moe-8x1": ("qwen3-moe-30b-a3b", [8, 1]),
    "qwen72-4x1": ("qwen2-72b", [4, 1]),
    "rwkv-4x1": ("rwkv6-1.6b", [4, 1]),
    "zamba-4x1": ("zamba2-2.7b", [4, 1]),
    "seamless-4x1": ("seamless-m4t-large-v2", [4, 1]),
    "seamless-4x2": ("seamless-m4t-large-v2", [4, 2]),  # 4/4 heads, d_ff and frontend_proj
    "pod-2x2x1": ("llama3-8b", [2, 2, 1]),
}
SP = {"sequence_parallel": True}
KV_ONLY = {"kv_tp": True, "attn_tp": False}
# the layouts the rules and their overrides give beyond the defaults, each on
# (4, 2) with uneven labels: case -> (arch, config overrides, rules overrides)
TRAIN_LAYOUTS = {
    "sp-llama-4x2": ("llama3-8b", SP, {}),  # heads split: the Megatron crossings
    "sp-qwen2-4x2": ("qwen2-1.5b", SP, {}),  # heads whole: gathered, then sliced
    "sp-moe-4x2": ("qwen3-moe-30b-a3b", SP, {}),  # experts: routing on the gathered sequence
    "sp-grok-4x2": ("grok-1-314b", SP, {}),  # tensor-parallel experts
    "sp-rwkv-4x2": ("rwkv6-1.6b", SP, {}),  # token shifts across a slice boundary
    "sp-zamba-4x2": ("zamba2-2.7b", SP, {}),  # the causal conv, the shared block
    "sp-seamless-4x2": ("seamless-m4t-large-v2", SP, {}),  # frames and tokens split apart
    "sp-pixtral-4x2": ("pixtral-12b", SP, {}),  # the prefix's global order
    "kv-minicpm-4x2": ("minicpm-2b", KV_ONLY, {}),  # 4 KV heads split, 4 query heads whole
    "zamba-heads-whole-4x2": ("zamba2-2.7b", {"attn_tp": False}, {}),  # and d_inner split
    "norm-on-model-4x2": ("llama3-8b", {}, {"norm": ["model"]}),  # an axis outside TP_AXES
    "embed-on-data-model-4x2": ("llama3-8b", {}, {"embed": ["data", "model"]}),  # FSDP over all
}
POOLS = {"7": [0, 1, 2, 3, 5, 6, 7], "6": [0, 1, 2, 3, 4, 5], "5": [7, 6, 5, 4, 3],
         "2": [3, 6]}
SERVE = {  # case -> (arch, global batch, forward too): on (4, 2), decode_32k's rules
    "serve-4x2": ("llama3-8b", 8, True),  # 1 KV head: the sequence on 'model', q gathered
    "serve-rwkv-4x2": ("rwkv6-1.6b", 8, True),
    "serve-zamba-4x2": ("zamba2-2.7b", 8, True),
    "serve-grok-4x2": ("grok-1-314b", 8, False),  # seq on 'model', softcap, experts split
    "serve-qwen2-4x2": ("qwen2-1.5b", 8, False),  # query heads whole: seq on 'model', no gather
    "serve-zamba-b1-4x2": ("zamba2-2.7b", 1, False),  # a batch of 1: seq on 'data'
    "serve-moe-b1-4x2": ("qwen3-moe-30b-a3b", 1, False),  # seq on ('data', 'model')
    "serve-seamless-4x2": ("seamless-m4t-large-v2", 8, True),  # KV heads split, TP enc-dec
    "serve-seamless-b1-4x2": ("seamless-m4t-large-v2", 1, False),  # self and enc k/v on 'data'
}
SPLIT_KV = {  # the cases whose cache the rules split along its sequence -> act_kv_seq
    "serve-4x2": ["model"], "serve-grok-4x2": ["model"], "serve-qwen2-4x2": ["model"],
    "serve-zamba-b1-4x2": ["data"], "serve-moe-b1-4x2": ["data", "model"],
    "serve-seamless-b1-4x2": ["data"]}
CACHE_CAP, CACHE_LEN = 32, 20  # a decode cache of 32 positions, 20 filled
KEPT_WHOLE = 33  # a capacity the divisibility guard keeps whole over 2 and over 4
# serve cases with overrides, on (4, 2): case -> (arch, global batch, forward too,
# config overrides, rules overrides, cache capacity, the rules' act_kv_seq, the
# cache leaves the guard keeps whole)
SERVE_LAYOUTS = {
    # sequence parallelism at a prefill shape, the vocabulary whole: the
    # logits are each rank's positions (the sequence on 'model')
    "serve-sp-4x2": ("llama3-8b", 8, True, SP, {"vocab": []}, CACHE_CAP, ["model"], []),
    "serve-sp-pixtral-4x2": ("pixtral-12b", 8, True, SP, {}, CACHE_CAP, ["model"], []),
    # KV heads split with the query heads whole, at 8 and at 1 (the sequence on
    # 'data'), and seamless's 4 KV heads with the rules' heads emptied
    "serve-kv-minicpm-4x2": ("minicpm-2b", 8, True, KV_ONLY, {}, CACHE_CAP, [], []),
    "serve-kv-minicpm-b1-4x2": ("minicpm-2b", 1, False, KV_ONLY, {}, CACHE_CAP, ["data"], []),
    "serve-seamless-heads-whole-4x2": ("seamless-m4t-large-v2", 8, False, {}, {"heads": []},
                                       CACHE_CAP, [], []),
    # a cache the guard keeps whole where act_kv_seq splits it; seamless's
    # encoder memory splits beside its whole self-attention cache
    "serve-kept-whole-4x2": ("llama3-8b", 8, False, {}, {}, KEPT_WHOLE, ["model"], ["k", "v"]),
    "serve-seamless-kept-whole-b1-4x2": ("seamless-m4t-large-v2", 1, False, {}, {}, KEPT_WHOLE,
                                         ["data"], ["k", "v"]),
}
# the plan carving over ranks (ROADMAP item 11b): run_executable's cases, each
# cold and warm, and the coordinator scenario, in submesh mode on 8 ranks
EXEC_RANK_CASES = [[p, r, fb] for p in ("vgg16@8", "inception@8") for r in ("mixed", "two")
                   for fb in (False, True)]
ENGINES = {  # case -> (arch, global batch): ServingEngine on (4, 2), decode rules
    "engine-llama-4x2": ("llama3-8b", 8),  # the cache's sequence on 'model'
    "engine-moe-b1-4x2": ("qwen3-moe-30b-a3b", 1),  # on ('data', 'model')
    "engine-rwkv-4x2": ("rwkv6-1.6b", 8),  # the prompt token by token
    "engine-seamless-4x2": ("seamless-m4t-large-v2", 8),
}
ENGINE_SPLIT = {"engine-llama-4x2": ["model"], "engine-moe-b1-4x2": ["data", "model"],
                "engine-kept-whole-4x2": ["model"], "engine-moe-4x2": ["model"],
                "engine-sp-4x2": ["model"]}
# engines beyond the decode cell's defaults: a capacity the guard keeps
# whole; qwen3-moe at a batch of 8 split over 'data' with a capacity factor
# at which every step drops pairs (``test_moe_engine_routes_one_group``)
MOE_DROPS = {"capacity_factor": 0.5}
ENGINE_OVERRIDES = {"engine-kept-whole-4x2": ("llama3-8b", 8, {"capacity": KEPT_WHOLE}),
                    "engine-moe-4x2": ("qwen3-moe-30b-a3b", 8, {"cfg": MOE_DROPS}),
                    # the fused prefill's 12 prompt tokens split over 'model'
                    "engine-sp-4x2": ("llama3-8b", 8, {"cfg": SP})}
ENGINES.update({n: v[:2] for n, v in ENGINE_OVERRIDES.items()})
SMOKE_TRACE = os.path.join(HERE, "..", "benchmarks", "traces", "requests_smoke.json")
DISAGG = {"kind": "disagg", "arch": "llama3-8b", "n_prefill": 2, "trace": SMOKE_TRACE,
          "engine": {"lanes": 4, "n_pages": 25, "page_tokens": 4, "lane_capacity": 24}}


def _engine_case(name):
    arch, batch = ENGINES[name]
    # 12 prompt tokens and 8 new ones: the writes cross from the first cache
    # slice into the next where the sequence is split
    return dict({"kind": "engine", "arch": arch, "mesh": [4, 2], "batch": batch, "capacity": 32,
                 "prompt": 12, "new": 8}, **ENGINE_OVERRIDES.get(name, (0, 0, {}))[2])


RANK_CASES = {"exec-8": {"kind": "exec", "cases": EXEC_RANK_CASES},
              "coord-8": {"kind": "coord"},
              **{n: _engine_case(n) for n in ENGINES},
              "disagg-8": DISAGG}
RAISE_LAYOUTS = {  # name -> (arch, step kind, global batch, cfg overrides, rules overrides)
    "sequence-parallel": ("llama3-8b", "train", 8, {"sequence_parallel": True}, {}),
    "kv-heads-split-query-heads-whole": ("seamless-m4t-large-v2", "decode", 8, {},
                                         {"heads": []}),
}
# the case that holds each of them against the reference
RAISE_HELD = {"sequence-parallel": "sp-llama-4x2",
              "kv-heads-split-query-heads-whole": "serve-seamless-heads-whole-4x2"}
SHARD_LEAF = "layers/attn/wq"
# the leaves whose gradients cross the tensor-parallel boundary in a way the
# design rule must get right (dist/fsdp.py): a norm over a split width, a
# whole parameter read by local heads, the MoE router
TP_GRAD_LEAVES = [("rwkv-4x2", "layers/mix/ln_x"), ("rwkv-4x2", "layers/mix/w_lora_b"),
                  ("rwkv-4x2", "layers/mix/cw_r"), ("zamba-4x2", "layers/mamba/gate_norm"),
                  ("zamba-4x2", "layers/mamba/wB"), ("moe-4x2", "layers/moe/router"),
                  ("grok-4x2", "layers/moe/router"), ("pixtral-4x2", "frontend_proj"),
                  ("seamless-4x2", "frontend_proj"), ("seamless-4x2", "dec_layers/cross_attn/wk"),
                  ("seamless-4x2", "enc_norm")]


def _train_case(name):
    if name in TRAIN_LAYOUTS:
        arch, cfg, rules = TRAIN_LAYOUTS[name]
        return {"kind": "train", "arch": arch, "mesh": [4, 2], "cfg": cfg, "rules": rules}
    arch, mesh = TRAIN[name]
    case = {"kind": "train", "arch": arch, "mesh": mesh}
    if name == "pod-2x2x1":
        case["shards"] = SHARD_LEAF
    if name == "llama-4x2":
        case["ckpt"] = "ckpt-4x2"
    return case


def _slice_len(name) -> int:
    """The positions a rank's cache slice holds: 32 over the shards of
    act_kv_seq on (4, 2)."""
    return CACHE_CAP // math.prod({"data": 4, "model": 2}[a] for a in SPLIT_KV.get(name, []))


def _serve_case(name):
    if name in SERVE_LAYOUTS:
        arch, batch, forward, cfg, rules, cap, split, whole = SERVE_LAYOUTS[name]
        # 20 positions filled, then the last position of the first slice
        local = cap if cap % 2 else cap // math.prod({"data": 4, "model": 2}[a] for a in split)
        return {"kind": "serve", "arch": arch, "mesh": [4, 2], "batch": batch,
                "forward": forward, "lens": [CACHE_LEN, local - 1], "cfg": cfg,
                "rules": rules, "cap": cap}
    arch, batch, forward = SERVE[name]
    # 20 positions filled (the write lands on a later slice where the cache
    # splits), then the last position of the first slice
    return {"kind": "serve", "arch": arch, "mesh": [4, 2], "batch": batch, "forward": forward,
            "lens": [CACHE_LEN, _slice_len(name) - 1]}


SPAWNS = [  # (mesh, cases), in order: the restore reads the (4, 2) spawn's checkpoint
    ([4, 2], {**{n: _train_case(n) for n in TRAIN if TRAIN[n][1] == [4, 2]},
              **{n: _train_case(n) for n in TRAIN_LAYOUTS},
              **{n: _serve_case(n) for n in list(SERVE) + list(SERVE_LAYOUTS)},
              "layouts-4x2": {"kind": "layouts", "mesh": [4, 2], "layouts": RAISE_LAYOUTS},
              "collectives-4x2": {"kind": "collectives", "arch": "llama3-8b", "mesh": [4, 2]},
              "collectives-sp-4x2": {"kind": "collectives", "arch": "llama3-8b", "mesh": [4, 2],
                                     "cfg": SP},
              **RANK_CASES,
              "tp-tenant": {"kind": "tp_tenant", "arch": "qwen2-1.5b", "batch": 6,
                            "steps": 3}}),
    ([8, 1], {"moe-8x1": _train_case("moe-8x1"),
              "remesh": {"kind": "remesh", "pools": POOLS}}),
    ([4, 1], {**{n: _train_case(n) for n in ("qwen72-4x1", "rwkv-4x1", "zamba-4x1",
                                            "seamless-4x1")},
              "restore-2x2": {"kind": "restore", "arch": "llama3-8b", "mesh": [2, 2],
                              "ckpt": "ckpt-4x2"},
              "bg-slice": {"kind": "bg_slice", "arch": "qwen2-1.5b"}}),
    ([2, 2, 1], {"pod-2x2x1": _train_case("pod-2x2x1")}),
]


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _check(cmd, env, timeout):
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference dir, port dir) after every case has run on both sides."""
    ref = str(tmp_path_factory.mktemp("ref"))
    port = str(tmp_path_factory.mktemp("port"))
    ref_cases = {n: _train_case(n) for n in list(TRAIN) + list(TRAIN_LAYOUTS)}
    ref_cases.update({n: _serve_case(n) for n in list(SERVE) + list(SERVE_LAYOUTS)})
    ref_cases["remesh"] = {"kind": "remesh", "pools": POOLS}
    ref_cases.update(RANK_CASES)
    _check([sys.executable, os.path.join(HERE, "_dist_reference.py"), ref,
            json.dumps(ref_cases)],
           _env(XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu"),
           600)
    for mesh, cases in SPAWNS:
        out = os.path.join(port, "x".join(map(str, mesh)))
        os.makedirs(out)
        # checkpoints live beside the spawns' own directories
        cases = {n: (dict(c, ckpt=os.path.join(port, c["ckpt"])) if "ckpt" in c else c)
                 for n, c in cases.items()}
        _check([sys.executable, os.path.join(HERE, "_dist_ranks.py"), ref, out,
                json.dumps(mesh), json.dumps(cases)], _env(), 600)
    return ref, port


def _port_file(port, name, ext="npz"):
    for mesh, cases in SPAWNS:
        if name in cases:
            return os.path.join(port, "x".join(map(str, mesh)), f"{name}-port.{ext}")
    raise KeyError(name)


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _noise(ref, key):
    """Where the reference's step for a parameter was rounding noise, after
    the first step or the last."""
    name = key[len("params/"):]
    out = None
    for when in ("first/", "opt/"):
        m = ref.get(f"{when}m/{name}", ref.get(f"{when}stats/{name}/v"))
        if m is not None:
            m = np.abs(m)
            hit = m < NOISE_FLOOR * m.max()
            out = hit if out is None else out | hit
    return out


def _held_to_reference(ref_dir, port, name):
    """Losses, every parameter and every first moment (Adafactor's
    statistics) of the port's 3 steps against the reference's."""
    ref = _npz(os.path.join(ref_dir, f"{name}-out.npz"))
    got = _npz(_port_file(port, name))
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_TOL)
    keys = sorted(k for k in ref if k.startswith(("params/", "opt/")))
    assert keys == sorted(k for k in got if k.startswith(("params/", "opt/")))
    for k in keys:
        w, g = ref[k], got[k]
        assert g.shape == w.shape, k
        if k.startswith("opt/"):
            np.testing.assert_allclose(g, w, rtol=MOMENT_TOL, atol=MOMENT_TOL, err_msg=k)
            continue
        noise = _noise(ref, k)
        tol = np.full(w.shape, PARAM_ATOL) if noise is None else np.where(
            noise, 2 * LR * STEPS, PARAM_ATOL)
        bad = np.abs(g - w) > tol + MOMENT_TOL * np.abs(w)
        assert not bad.any(), (k, float(np.abs(g - w)[bad].max()), int(bad.sum()))
    return got


@pytest.mark.parametrize("name", sorted(TRAIN) + sorted(TRAIN_LAYOUTS))
def test_train_step_matches_reference_sharded(runs, name):
    """3 steps of the port's ``jit_train_step`` on gloo ranks: losses,
    every parameter and every first moment (Adafactor's statistics) equal
    the reference's ``jit_train_step`` on the same mesh shape, with the
    same config and rules overrides (``TRAIN_LAYOUTS``: sequence
    parallelism for every family, KV heads split with the query heads
    whole, Mamba-2's ``d_inner`` split over whole heads, parameters split
    on 'model' along ``norm`` or ``embed``)."""
    _held_to_reference(*runs, name)


@pytest.mark.parametrize("name", sorted(n for n in TRAIN_LAYOUTS if n.startswith("sp-")))
def test_sequence_parallel_splits_the_inputs(runs, name):
    """The sequence-parallel cases run split: each input's sequence lies on
    'model' (seamless's frames and tokens each by their own guard,
    pixtral's patches and text), the batch on 'data'."""
    got = _npz(_port_file(runs[1], name))
    keys = [k for k in got if k.startswith("placements/")]
    assert keys and {k: got[k].tolist() for k in keys} == {k: ["S(0)", "S(1)"] for k in keys}


@pytest.mark.parametrize("name,leaf", TP_GRAD_LEAVES)
def test_tp_crossing_gradients_match_reference(runs, name, leaf):
    """The first step's moments of the leaves whose gradients cross the
    tensor-parallel boundary (AdamW's first moment is a tenth of the
    clipped gradient; Adafactor's statistics its square), on the (4, 2)
    mesh, against the reference's to 1e-5: a missing ``tp_copy`` leaves a
    rank's partial gradient in a parameter the rules keep whole."""
    ref_dir, port = runs
    ref = _npz(os.path.join(ref_dir, f"{name}-out.npz"))
    got = _npz(_port_file(port, name))
    keys = sorted(k for k in ref if k.startswith((f"first/m/{leaf}", f"first/stats/{leaf}/")))
    assert keys and keys == sorted(k for k in got if k.startswith(
        (f"first/m/{leaf}", f"first/stats/{leaf}/"))), (keys, leaf)
    for k in keys:
        w = ref[k]
        np.testing.assert_allclose(got[k], w, rtol=MOMENT_TOL, atol=MOMENT_TOL * np.abs(w).max(),
                                   err_msg=k)


def test_uneven_labels_are_a_global_mean(runs):
    """The batches put the masked labels unevenly across the data shards
    (the (8, 1) mesh gives each rank one row), and the loss the ranks
    agree on is the global masked mean, which a mean of per-rank means
    would miss by far more than the tolerance."""
    import torch

    from repro_torch.checkpoint.ckpt import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    ref_dir, port = runs
    inp = _npz(os.path.join(ref_dir, "moe-8x1-in.npz"))
    labels = inp["batch/labels"]
    per_row = (labels >= 0).sum(axis=1)
    assert len(set(per_row.tolist())) > 2  # uneven across the 8 shards
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), dtype="float32")
    linp = _npz(os.path.join(ref_dir, "llama-4x2-in.npz"))
    params = params_from_numpy({k[7:]: v for k, v in linp.items() if k.startswith("params/")},
                               device="cpu")
    tokens = torch.as_tensor(linp["batch/tokens"]).long()
    lab = torch.as_tensor(linp["batch/labels"]).long()
    api = get_model(cfg)
    with torch.no_grad():
        glob, _ = api.loss(params, {"tokens": tokens, "labels": lab})
        rows = [float(api.loss(params, {"tokens": tokens[i:i + 2], "labels": lab[i:i + 2]})[0])
                for i in range(0, 8, 2)]
    got = _npz(_port_file(port, "llama-4x2"))["losses"][0]
    np.testing.assert_allclose(got, float(glob), rtol=LOSS_TOL)
    assert abs(np.mean(rows) - float(glob)) > 100 * LOSS_TOL * float(glob)


def test_moe_groups_follow_the_data_axis(runs):
    """At (8, 1) the reference splits the MoE capacity into 8 groups; the
    port's loss matches that, not the one-group loss of the same batch."""
    import torch

    from repro_torch.checkpoint.ckpt import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    ref_dir, port = runs
    inp = _npz(os.path.join(ref_dir, "moe-8x1-in.npz"))
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(), dtype="float32")
    params = params_from_numpy({k[7:]: v for k, v in inp.items() if k.startswith("params/")},
                               device="cpu")
    batch = {k[6:]: torch.as_tensor(v).long() for k, v in inp.items()
             if k.startswith("batch/")}
    with torch.no_grad():
        one_group = float(get_model(cfg).loss(params, batch)[0])
    ref = _npz(os.path.join(ref_dir, "moe-8x1-out.npz"))["losses"][0]
    got = _npz(_port_file(port, "moe-8x1"))["losses"][0]
    np.testing.assert_allclose(got, ref, rtol=LOSS_TOL)
    assert abs(one_group - ref) > 10 * LOSS_TOL * ref


def test_pod_and_data_shard_pod_major(runs):
    """On a (2, 2, 1) (pod, data, model) mesh the leaf's ``embed`` dim is
    split over ("pod", "data"): each rank's DTensor shard equals the
    reference's addressable shard for the device at the same coordinates."""
    ref_dir, port = runs
    ref = _npz(os.path.join(ref_dir, "pod-2x2x1-out.npz"))
    shards = {k[len("shard/"):]: v for k, v in ref.items() if k.startswith("shard/")}
    assert len(shards) == 4
    out = os.path.dirname(_port_file(port, "pod-2x2x1"))
    for coord, want in shards.items():
        got = np.load(os.path.join(out, f"pod-2x2x1-shard-{coord}.npy"))
        np.testing.assert_array_equal(got, want, err_msg=coord)
    assert len({v.tobytes() for v in shards.values()}) == 4


@pytest.mark.parametrize("key", ["logits", "decode_logits", "cache/k", "cache/v",
                                 "end/decode_logits", "end/cache/k", "end/cache/v"])
def test_forward_and_decode_match_reference_sharded(runs, key):
    """``jit_forward`` (prefill shape) and ``jit_decode_step`` (a seeded
    cache, 20 positions filled, then 15: the end of the first slice) of
    reduced llama3-8b at (4, 2): heads, MLP and vocabulary split over
    'model'; the one KV head cannot split, so the decode rules put the
    cache's sequence on 'model' on both sides (split-KV decoding, ``q``
    gathered over 'model')."""
    ref_dir, port = runs
    want = _npz(os.path.join(ref_dir, "serve-4x2-out.npz"))[key]
    got = _npz(_port_file(port, "serve-4x2"))
    np.testing.assert_allclose(got[key], want, rtol=0, atol=OUT_TOL * np.abs(want).max())
    if key == "logits":  # batch over 'data', vocabulary over 'model'
        assert got["logits_placements"].tolist() == ["S(0)", "S(2)"]


def test_elastic_checkpoint_restore_across_meshes(runs):
    """Saved on (4, 2) after training, restored onto (2, 2) through the
    target mesh's shardings: every parameter equal, placed by (2, 2)'s
    rules (mirrors the reference's test of the same name)."""
    _, port = runs
    saved = _npz(_port_file(port, "llama-4x2"))
    got = _npz(_port_file(port, "restore-2x2"))
    assert int(got["step"]) == STEPS
    keys = [k for k in saved if k.startswith("params/")]
    assert keys and sorted(keys) == sorted(k for k in got if k.startswith("params/"))
    for k in keys:
        np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
    # wq (L, D, H, hd): embed over data, heads over model on (2, 2)
    assert got["placements"].tolist() == ["S(1)", "S(2)"]
    assert got["local_shape"].tolist() == [2, 64, 2, 32]


SERVE_KEYS = {"serve-rwkv-4x2": ["cache/wkv", "cache/tm_shift", "cache/cm_shift"],
              "serve-zamba-4x2": ["cache/ssm", "cache/conv", "cache/k", "cache/v"]}


@pytest.mark.parametrize("name,key", [(n, k) for n in sorted(SERVE_KEYS)
                                      for k in ["logits", "decode_logits"] + SERVE_KEYS[n]])
def test_recurrent_forward_and_decode_match_reference_sharded(runs, name, key):
    """``jit_forward`` and ``jit_decode_step`` of reduced rwkv6 and zamba2
    at (4, 2): their heads (WKV-6, SSD and the shared attention), d_inner,
    MLPs and vocabulary split over 'model'; the decode state split by heads
    (``wkv``, ``ssm``, the shared block's ``k``/``v``) and channels
    (``conv``), written as the reference writes it."""
    ref_dir, port = runs
    want = _npz(os.path.join(ref_dir, f"{name}-out.npz"))[key]
    got = _npz(_port_file(port, name))
    np.testing.assert_allclose(got[key], want, rtol=0, atol=OUT_TOL * np.abs(want).max())
    if key == "logits":
        assert got["logits_placements"].tolist() == ["S(0)", "S(2)"]


SPLIT_CASES = [(n, pre + k) for n in sorted(SERVE) if n not in SERVE_KEYS and n != "serve-4x2"
               for pre in ("", "end/")
               for k in ["decode_logits", "cache/k", "cache/v"]
               + (["cache/ssm", "cache/conv"] if "zamba" in n else [])]


@pytest.mark.parametrize("name,key", SPLIT_CASES)
def test_split_kv_decode_matches_reference_sharded(runs, name, key):
    """``jit_decode_step`` at (4, 2) with the rules' own decode layout, at 20
    positions filled and at the end of the first cache slice (``end/``),
    against the reference's: grok-1 (the sequence on 'model', softcap,
    experts split), qwen2-1.5b (query heads whole: no gather), zamba2 at a
    batch of 1 (the sequence on 'data'; its window of 64 spans the cache),
    qwen3-moe at a batch
    of 1 (on ('data', 'model'): 8 slices), seamless at 8 (KV heads split,
    the tensor-parallel decoder and cross-attention) and at 1 (its cache
    and encoder memory on 'data', which the cross-attention reads split).
    Logits and every cache leaf the step writes to 1e-5 of the largest
    magnitude; the reference's rules split the sequence as the case
    says."""
    ref_dir, port = runs
    ref = _npz(os.path.join(ref_dir, f"{name}-out.npz"))
    assert [a for a in ref["act_kv_seq"].tolist() if a] == SPLIT_KV.get(name, [])
    want = ref[key]
    got = _npz(_port_file(port, name))[key]
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL * np.abs(want).max())


def test_seamless_forward_matches_reference_sharded(runs):
    """Reduced seamless's ``jit_forward`` at (4, 2): the encoder, decoder and
    cross-attention heads, ``d_ff`` and ``frontend_proj`` split over
    'model'."""
    ref_dir, port = runs
    want = _npz(os.path.join(ref_dir, "serve-seamless-4x2-out.npz"))["logits"]
    got = _npz(_port_file(port, "serve-seamless-4x2"))
    np.testing.assert_allclose(got["logits"], want, rtol=0, atol=OUT_TOL * np.abs(want).max())
    assert got["logits_placements"].tolist() == ["S(0)", "S(2)"]


@pytest.mark.parametrize("layout", sorted(RAISE_LAYOUTS))
def test_item_11b_layouts_raise(runs, layout):
    """The layouts item 11b once refused build their step on the 8 gloo
    ranks (sequence parallelism on a 'model' axis, and KV heads split over
    'model' while the query heads stay whole: seamless's 4 KV heads with
    the rules' ``heads`` emptied), and what each computes equals the
    reference's (``RAISE_HELD``: 3 train steps, or the decode's logits and
    cache)."""
    ref_dir, port = runs
    with open(_port_file(port, "layouts-4x2", "json")) as f:
        assert json.load(f)[layout] == "builds"
    held = RAISE_HELD[layout]
    if held in TRAIN_LAYOUTS:
        _held_to_reference(ref_dir, port, held)
        return
    want, got = _npz(os.path.join(ref_dir, f"{held}-out.npz")), _npz(_port_file(port, held))
    for key in ("decode_logits", "cache/k", "cache/v", "cache/enc_k", "end/decode_logits"):
        if key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=OUT_TOL * np.abs(want[key]).max(), err_msg=key)


LAYOUT_KEYS = ["decode_logits", "cache/k", "cache/v", "end/decode_logits", "end/cache/k",
               "end/cache/v"]


@pytest.mark.parametrize("name,key", [(n, k) for n in sorted(SERVE_LAYOUTS)
                                      for k in (["logits"] if SERVE_LAYOUTS[n][2] else [])
                                      + LAYOUT_KEYS])
def test_layouts_forward_and_decode_match_reference(runs, name, key):
    """``jit_forward`` and ``jit_decode_step`` at (4, 2) with the case's
    overrides against the reference's, to 1e-5 of the largest magnitude:
    sequence parallelism at a prefill shape (llama3-8b with its vocabulary
    whole, so the logits lie split along the sequence; pixtral's prefix);
    KV heads split with the query heads whole (minicpm-2b at a batch of 8
    and of 1, whose cache then splits over 'data'; seamless with the rules'
    ``heads`` emptied); a capacity of 33, which the guard keeps whole where
    the rules split it (llama3-8b; seamless at a batch of 1, whose encoder
    memory splits over 'data' beside its whole self-attention cache).  The
    reference's rules split the cache as the case says, and the placements
    name which leaves stay whole."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.dist.sharding import param_pspecs, sharding_rules
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.api import get_model

    ref_dir, port = runs
    arch, batch, _, cfg_over, rules_over, cap, split, whole = SERVE_LAYOUTS[name]
    ref = _npz(os.path.join(ref_dir, f"{name}-out.npz"))
    assert [a for a in ref["act_kv_seq"].tolist() if a] == split
    got = _npz(_port_file(port, name))
    np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=OUT_TOL * np.abs(ref[key]).max())
    if key == "logits":  # batch over 'data'; the vocabulary over 'model', or the sequence
        want = ["S(0)", "S(2)"] if not rules_over.get("vocab") == [] else ["S(0)", "S(1)"]
        assert got["logits_placements"].tolist() == want
    cfg = dataclasses.replace(_small_arch(arch), **cfg_over)
    mesh = AbstractMesh((4, 2), ("data", "model"))
    rules = dict(sharding_rules(cfg, mesh, ShapeConfig("d", cap, batch, "decode")),
                 **{k: tuple(v) for k, v in rules_over.items()})
    specs = param_pspecs(get_model(cfg).cache_schema(batch, cap), rules, mesh)
    kept = sorted(k for k, sp in specs.items() if split and (len(sp) < 3 or sp[2] is None))
    assert kept == sorted(whole), specs


def _small_arch(arch):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def test_moe_engine_routes_one_group(runs):
    """``ServingEngine(mesh=(4, 2))`` serving qwen3-moe at a batch of 8,
    split over 'data', routes each step's tokens as one group over the
    whole batch, as the reference's engine does: at a capacity factor of
    0.5 every step drops pairs (its experts' slots hold fewer than its
    pairs), so a rank's rows routed as a group of their own would keep
    other pairs; the tokens equal the reference's."""
    from repro_torch.models.moe import _capacity

    ref_dir, port = runs
    cfg = dataclasses.replace(_small_arch("qwen3-moe-30b-a3b"), **MOE_DROPS)
    case = _engine_case("engine-moe-4x2")
    for tokens in (case["batch"], case["batch"] * case["prompt"]):  # a decode step, the prefill
        assert cfg.num_experts * _capacity(tokens, cfg) < tokens * cfg.experts_per_tok
    want = _npz(os.path.join(ref_dir, "engine-moe-4x2-out.npz"))
    got = _npz(_port_file(port, "engine-moe-4x2"))
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_fake_group_counts_the_gloo_ranks_collectives(runs):
    """``launch.op_analysis`` on rank 0 of a fake (4, 2) process group (the
    dry-run's ``run_step``, fake meta tensors) counts the collective bytes,
    by kind, that it counts on rank 0 of 8 gloo ranks running the same
    step."""
    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.launch.dryrun import run_step
    from repro_torch.launch.mesh import fake_world, make_mesh

    _, port = runs
    with open(_port_file(port, "collectives-4x2", "json")) as f:
        gloo = json.load(f)
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), dtype="float32")
    shape = dataclasses.replace(TRAIN_4K, seq_len=16, global_batch=8, name="t")
    with fake_world(8, "meta"):
        rec = run_step(cfg, shape, make_mesh(4, 2), "meta")
    assert rec["collective_bytes"] == gloo["collectives"]
    assert rec["collective_diag"]["n_collective_ops"] == gloo["n_collective_ops"] > 0
    assert set(gloo["collectives"]) == {"all-gather", "all-reduce", "reduce-scatter"}


def test_gloo_ranks_count_known_collective_operand_bytes(runs):
    """On the same 8 gloo ranks, one call of each collective on tensors of
    known sizes counts each kind's operand bytes: an all-gather's own
    piece, a reduce-scatter's whole input
    (``_dist_ranks.primitive_collectives``)."""
    import _dist_ranks

    _, port = runs
    with open(_port_file(port, "collectives-4x2", "json")) as f:
        gloo = json.load(f)
    assert gloo["world"] == 8
    assert gloo["primitives"] == _dist_ranks.primitive_collectives(8)[2]


def test_step_collective_bytes_equal_the_analytic_count(runs):
    """The collective bytes of reduced llama3-8b's train step on the (4, 2)
    gloo ranks (fp32, 8 x 16), counted from the sharding specs and the
    model's structure alone:

      - all-gather: each leaf split over 'data' gathers this rank's piece
        at its use, the layers' twice (``remat_policy`` 'full' recomputes
        each layer's forward in the backward), the embedding and the head
        once;
      - reduce-scatter: each such leaf's gradient once, in its gathered
        (tensor-parallel only) layout;
      - all-reduce, of (B/4, S, D) activations: the embedding's
        vocab-parallel sum, each layer's attention and MLP row-parallel
        sums, the attention's again in the recompute (which stops at the
        last tensor the backward saved, before the MLP's sum), the
        gradients of each layer's two column-parallel inputs and of the
        head's input; of (B/4, S, KV, dh): the K and V projections'
        gradients (the KV heads are whole on every rank); of (B/4, S): the
        vocab-parallel cross-entropy's max, sum of exponentials and target
        logit; two scalars for the global mean; the norms' gradients."""
    import math

    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.dist.sharding import pspec, sharding_rules
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.api import get_model

    _, port = runs
    with open(_port_file(port, "collectives-4x2", "json")) as f:
        gloo = json.load(f)
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), dtype="float32")
    shape = dataclasses.replace(TRAIN_4K, seq_len=16, global_batch=8, name="t")
    dp, tp = 4, 2
    mesh = AbstractMesh((dp, tp), ("data", "model"))
    rules = sharding_rules(cfg, mesh, shape)
    api = get_model(cfg)
    axes = flatten(api.axes())
    gather = scatter = 0
    for key, leaf in flatten(api.abstract()).items():
        spec = pspec(axes[key], leaf.shape, rules, mesh)
        names = {a for p in spec if p for a in ((p,) if isinstance(p, str) else p)}
        if "data" not in names:
            continue
        gathered = math.prod(leaf.shape) * leaf.dtype.itemsize // (tp if "model" in names else 1)
        assert cfg.remat_policy == "full"
        gather += (2 if key.startswith("layers/") else 1) * gathered // dp
        scatter += gathered
    B, S, D, L = shape.global_batch // dp, shape.seq_len, cfg.d_model, cfg.num_layers
    reduce = 4 * ((1 + 2 * L + L + 2 * L + 1) * B * S * D
                  + 2 * L * B * S * cfg.num_kv_heads * cfg.d_head
                  + 3 * B * S + 2 + (2 * L + 1) * D)
    assert gloo["collectives"] == {"all-gather": gather, "reduce-scatter": scatter,
                                   "all-reduce": reduce}


def test_fake_group_counts_the_sp_step_collectives(runs):
    """As ``test_fake_group_counts_the_gloo_ranks_collectives``, for the
    same step with sequence parallelism: the fake (4, 2) group's counts,
    by kind, equal the gloo ranks'."""
    from repro_torch.configs import TRAIN_4K
    from repro_torch.launch.dryrun import run_step
    from repro_torch.launch.mesh import fake_world, make_mesh

    _, port = runs
    with open(_port_file(port, "collectives-sp-4x2", "json")) as f:
        gloo = json.load(f)
    cfg = dataclasses.replace(_small_arch("llama3-8b"), **SP)
    shape = dataclasses.replace(TRAIN_4K, seq_len=16, global_batch=8, name="t")
    with fake_world(8, "meta"):
        rec = run_step(cfg, shape, make_mesh(4, 2), "meta")
    assert rec["collective_bytes"] == gloo["collectives"]
    assert rec["collective_diag"]["n_collective_ops"] == gloo["n_collective_ops"] > 0


def test_sp_step_collective_bytes_equal_the_analytic_count(runs):
    """The same step with sequence parallelism on the (4, 2) gloo ranks:
    the FSDP gathers and scatters of the parameters are the ones without it
    (``test_step_collective_bytes_equal_the_analytic_count``); the
    sequence's crossings move (B/4, S/2, D) pieces, ``P`` bytes, in each
    all-gather and (B/4, S, D) inputs, ``2 P``, in each reduce-scatter
    (an operand's bytes):

      - all-gather: each layer's two entries forward, again in the
        recompute (which stops before the MLP's exit), and the gradients
        of its two exits; the entry of the unembedding; the gradient of
        the embedding's exit; the token ids and the labels (int64);
      - reduce-scatter: each layer's two exits, the attention's again in
        the recompute, and the gradients of its two entries; the
        embedding's exit and the gradient of the unembedding's entry;
      - all-reduce: the vocab-parallel cross-entropy's max, sum and target
        logit over the whole sequence (B/4, S); two scalars for the global
        mean; the gradients of the norm scales over 'data' (the batch's
        partial sums, as without sequence parallelism) and over 'model'
        (read by each rank's positions); those of the whole K/V weights
        over 'model' (read by each rank's query heads)."""
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.configs import TRAIN_4K
    from repro_torch.dist.sharding import pspec, sharding_rules
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.api import get_model

    _, port = runs
    with open(_port_file(port, "collectives-sp-4x2", "json")) as f:
        gloo = json.load(f)
    cfg = dataclasses.replace(_small_arch("llama3-8b"), **SP)
    shape = dataclasses.replace(TRAIN_4K, seq_len=16, global_batch=8, name="t")
    dp, tp = 4, 2
    mesh = AbstractMesh((dp, tp), ("data", "model"))
    rules = sharding_rules(cfg, mesh, shape)
    api = get_model(cfg)
    axes = flatten(api.axes())
    gather = scatter = 0
    for key, leaf in flatten(api.abstract()).items():
        spec = pspec(axes[key], leaf.shape, rules, mesh)
        names = {a for p in spec if p for a in ((p,) if isinstance(p, str) else p)}
        if "data" not in names:
            continue
        gathered = math.prod(leaf.shape) * leaf.dtype.itemsize // (tp if "model" in names else 1)
        assert cfg.remat_policy == "full"
        gather += (2 if key.startswith("layers/") else 1) * gathered // dp
        scatter += gathered
    B, S, D, L = shape.global_batch // dp, shape.seq_len, cfg.d_model, cfg.num_layers
    piece = 4 * B * (S // tp) * D
    ids = 8 * B * (S // tp)
    gather += L * (2 + 2 + 2) * piece + 2 * piece + 2 * ids
    scatter += L * (2 + 1 + 2) * 2 * piece + 2 * 2 * piece
    reduce = 4 * (3 * B * S + 2 + 2 * (2 * L + 1) * D
                  + 2 * L * D * cfg.num_kv_heads * cfg.d_head)
    assert gloo["collectives"] == {"all-gather": gather, "reduce-scatter": scatter,
                                   "all-reduce": reduce}


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_remesh_for_pool_matches_reference(runs, pool):
    ref_dir, port = runs
    with open(os.path.join(ref_dir, "remesh-out.json")) as f:
        want = json.load(f)[pool]
    with open(_port_file(port, "remesh", "json")) as f:
        got = json.load(f)[pool]
    assert got == want


def test_bg_step_on_a_rank_slice(runs):
    """``bg_step_factory`` on a slice over all 4 ranks (its DeviceMesh,
    the sharded step) trains as the same factory on one CPU position."""
    _, port = runs
    with open(_port_file(port, "bg-slice", "json")) as f:
        got = json.load(f)
    assert got["shape"] == [4, 1] and got["mesh"] == [4, 1]
    np.testing.assert_allclose(got["sharded"], got["plain"], rtol=LOSS_TOL)
    assert got["sharded"][-1] < got["sharded"][0]


# -- the loop and the CLI in a world of one, and the CLI on 4 gloo ranks -------


@pytest.fixture
def world_of_one(tmp_path):
    """A one-rank gloo group and its (1, 1) mesh, torn down after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1)
    try:
        yield make_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def _small():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("llama3-8b").reduced(), dtype="float32")


def _loop_shape():
    from repro_torch.configs import TRAIN_4K

    return dataclasses.replace(TRAIN_4K, seq_len=16, global_batch=2, name="t")


def test_loop_with_a_mesh_equals_the_plain_loop_and_restarts(world_of_one, tmp_path):
    """``train(..., mesh=)`` on a (1, 1) mesh gives the plain loop's
    losses bit for bit, and its checkpoint/restart path (DTensor state
    saved by rank 0, restored through the mesh's shardings) reproduces
    the clean run."""
    from torch.distributed.tensor import DTensor

    from repro_torch.train.loop import TrainConfig, train

    cfg, shape = _small(), _loop_shape()
    plain = train(cfg, shape, TrainConfig(steps=6), device="cpu")
    sharded = train(cfg, shape, TrainConfig(steps=6), device="cpu", mesh=world_of_one)
    assert sharded.losses == plain.losses
    assert isinstance(sharded.state["params"]["embed"], DTensor)
    fired = []

    def injector(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("injected fault")

    tc = TrainConfig(steps=6, ckpt_dir=str(tmp_path / "ck"), ckpt_every=2)
    faulty = train(cfg, shape, tc, fault_injector=injector, device="cpu", mesh=world_of_one)
    assert faulty.restarts == 1
    np.testing.assert_allclose(faulty.losses, plain.losses[:3] + plain.losses[2:], rtol=1e-6)


def test_train_cli_data_model_in_a_world_of_one(capsys):
    """``--data 1 --model 1`` needs no launcher and prints the same losses
    as the plain CLI."""
    from repro_torch.launch import train as cli

    args = ["--arch", "llama3-8b", "--steps", "3", "--batch", "2", "--seq", "16",
            "--device", "cpu"]
    cli.main(args)
    plain = capsys.readouterr().out.splitlines()[-1]
    cli.main(args + ["--data", "1", "--model", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[-2] == "sharded step on mesh {'data': 1, 'model': 1}"
    assert out[-1].split(" mean_step")[0] == plain.split(" mean_step")[0]
    with pytest.raises(SystemExit):
        cli.main(args + ["--data", "2", "--model", "2"])  # 4 ranks need a launcher


def test_train_cli_under_torch_distributed_run(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 4 ... --data 2
    --model 2`` on the CPU (gloo): rank 0 prints the mesh and losses within
    bf16's tolerance (1e-2 relative: the reduced config computes in bf16,
    and tensor parallelism sums in another order) of the plain CLI's (the
    rendezvous takes a free port of its own)."""
    args = ["-m", "repro_torch.launch.train", "--arch", "llama3-8b", "--steps", "3",
            "--batch", "4", "--seq", "16", "--device", "cpu"]
    env = _env(OMP_NUM_THREADS="1")
    plain = subprocess.run([sys.executable] + args, capture_output=True, text=True,
                           timeout=300, env=env)
    assert plain.returncode == 0, plain.stderr[-3000:]
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "4"] + args + ["--data", "2", "--model", "2"],
                       capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith(("sharded", "done"))]
    assert lines[0] == "sharded step on mesh {'data': 2, 'model': 2}"
    done = plain.stdout.splitlines()[-1]
    got, want = ([float(x) for x in ln.split("loss ")[1].split(" restarts")[0].split(" -> ")]
                 for ln in (lines[1], done))
    np.testing.assert_allclose(got, want, rtol=1e-2)


# -- burst-parallel plans carved into rank slices (ROADMAP item 11b) ----------


def _per_rank(port, name):
    out = os.path.dirname(_port_file(port, name, "json"))
    return [json.load(open(os.path.join(out, f"{name}-port-{r}.json"))) for r in range(8)]


@pytest.mark.parametrize("i", range(len(EXEC_RANK_CASES)),
                         ids=["-".join(map(str, c)) for c in EXEC_RANK_CASES])
def test_run_executable_over_rank_slices_matches_reference(runs, i):
    """``Collocator(ranks=range(8)).run_executable`` under the scripted
    clock, cold then warm: on every rank the result (floats exact), the
    bans and the rotation round equal the reference's on 8 devices; each
    rank called exactly the stage and step functions whose slices hold it,
    as many times as the same case issues them on 8 CPU positions of one
    process."""
    ref_dir, port = runs
    with open(os.path.join(ref_dir, "exec-8-out.json")) as f:
        want = json.load(f)[i]
    issued = set()
    for rank, got in enumerate(_per_rank(port, "exec-8")):
        got = got[i]
        assert got["runs"] == want, rank
        assert got["issued"] == got["share"], rank
        issued |= {tuple(json.loads(k)[:2]) for k in got["issued"]}
    (cold, _, _), (warm, _, _) = want
    # the ranks issued stages, and tenant steps where the plan's gaps take any
    # (the inception's parallel branches fill its gap)
    assert {k for k, _ in issued} == ({"fg", "bg"} if cold[1]["bg_steps_per_iter"] else {"fg"})
    assert cold[1]["iterations"] > 0 and warm[1]["cache_misses"] == 0


def test_collocate_over_ranks_matches_reference(runs):
    """``ClusterCoordinator.collocate(executable=True)`` in submesh mode
    with its positions on the 8 ranks: admission, the run, a failure of
    position 2 (its cache entries evicted, the plan re-carved over the 7
    surviving ranks, rank 2 holding no slice), the join and a bound that
    admits nobody give every rank the reference's rows and events."""
    ref_dir, port = runs
    with open(os.path.join(ref_dir, "coord-8-out.json")) as f:
        want = json.load(f)
    for rank, got in enumerate(_per_rank(port, "coord-8")):
        assert got == want, rank
    kinds = [k for k, _ in want[-1]]
    assert "fallback" not in kinds and "evict" in kinds and ["replan", "G=7"] in want[-1]


def test_tp_tenant_on_a_rank_slice(runs):
    """A tenant of quantum 2 on the widest gap slice VGG-16@8's plan gives
    it over the ranks, a (3, 2) rank slice (tensor parallelism over its
    'model' axis): its fp32 losses equal the same tenant's on one CPU
    position to 1e-5; the ranks outside the slice build nothing."""
    _, port = runs
    got = _per_rank(port, "tp-tenant")
    assert {tuple(g["shape"]) for g in got} == {(3, 2)}
    ranks = got[0]["ranks"]
    for rank, g in enumerate(got):
        assert g["member"] == (rank in ranks), rank
        if g["member"]:
            np.testing.assert_allclose(g["sharded"], g["plain"], rtol=LOSS_TOL)
            assert g["sharded"][-1] < g["sharded"][0]


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_serving_engine_on_a_mesh_matches_reference(runs, name):
    """``ServingEngine(mesh=(4, 2), rules=decode rules)`` on the reference's
    weights and prompts: ``generate``'s tokens equal the reference's
    engine on the same mesh; the prefill's last logits and the last
    decode step's to 1e-5 of the largest; on every rank the cache is
    placed as the rules say after the prefill and after the last step
    (the fused prefill keeps each rank's share of the sequence where the
    rules split it).  Beyond the decode cell's defaults: a capacity of 33,
    which the guard keeps whole; qwen3-moe at a batch of 8 split over
    'data' (``test_moe_engine_routes_one_group``); llama3-8b with sequence
    parallelism, whose 12 prompt tokens the fused prefill splits over
    'model'."""
    ref_dir, port = runs
    want = _npz(os.path.join(ref_dir, f"{name}-out.npz"))
    got = _npz(_port_file(port, name))
    assert [a for a in want["act_kv_seq"].tolist() if a] == ENGINE_SPLIT.get(name, [])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for key in ("prefill_logits", "last_logits"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=OUT_TOL * np.abs(want[key]).max(), err_msg=key)
    out = os.path.dirname(_port_file(port, name))
    for rank in range(8):
        with open(os.path.join(out, f"{name}-placed-{rank}.json")) as f:
            assert json.load(f) == [True, True], rank


def test_disaggregated_over_rank_slices_matches_reference(runs):
    """``ContinuousBatchingEngine(submeshes=split_mesh_for_serving(2,
    ranks=))``: prefill on ranks [0, 2), decode on [2, 8).  Over the smoke
    trace every rank holds each request's tokens equal to the reference's
    disaggregated engine on 8 devices, one handoff per admit, and no page
    held."""
    ref_dir, port = runs
    with open(os.path.join(ref_dir, "disagg-8-out.json")) as f:
        want = json.load(f)
    assert len(want["tokens"]) == 24 and want["used_pages"] == 0
    for rank, got in enumerate(_per_rank(port, "disagg-8")):
        assert got["tokens"] == want["tokens"], rank
        assert got["handoffs"] == got["prefills"] == 24 and got["used_pages"] == 0, rank
        assert got["ranges"] == [[0, 2], [2, 8]]
        assert got["roles"] == [rank < 2, rank >= 2], rank
