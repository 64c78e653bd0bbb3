"""The port's optimizer (``repro_torch.optim.optimizer``) against the
reference's: five AdamW updates and five Adafactor updates on the same
gradients (fp32, 1e-6), the schedules at a list of steps, global-norm
clipping, the state schemas and ``make_optimizer``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizer as ref_opt
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.optim import optimizer as opt
from repro_torch.configs import get_config
from test_torch_bridge import port_config, small_config

TOL = 1e-6
STEPS = [0, 1, 5, 9, 10, 11, 50, 79, 80, 81, 95, 100, 150]


def _tree(seed, scale=1.0):
    """numpy leaves of every rank the optimizer distinguishes (decay only on
    ndim >= 2), in nested dicts."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return {"a": {"w": mk(6, 5), "b": mk(5)}, "layers": {"w": mk(2, 4, 3), "n": mk(2, 4)},
            "z": mk(7)}


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, tol=TOL):
    for g, w in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=tol)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # below / above the clip norm of 1
def test_adamw_five_updates(grad_scale):
    sched_args = dict(peak_lr=1e-2, warmup=2, total=10)
    ref = ref_opt.adamw(ref_opt.cosine_schedule(**sched_args))
    port = opt.adamw(opt.cosine_schedule(**sched_args))
    p0 = _tree(0)
    jp, jstate = _jax(p0), None
    tp = _torch(p0)
    jstate, tstate = ref.init(jp), port.init(tp)
    for i in range(5):
        g = _tree(10 + i, grad_scale)
        jp, jstate = ref.update(_jax(g), jstate, jp)
        tp, tstate = port.update(_torch(g), tstate, tp)
        _close(tp, jp)
        _close(tstate["m"], jstate["m"])
        _close(tstate["v"], jstate["v"])
        assert int(tstate["count"]) == int(jstate["count"]) == i + 1
        assert tstate["count"].dtype == torch.int32


def test_adamw_updates_in_place():
    port = opt.adamw(opt.constant_schedule(1e-3))
    tp = _torch(_tree(1))
    state = port.init(tp)
    new_p, new_state = port.update(_torch(_tree(2)), state, tp)
    assert new_p["a"]["w"] is tp["a"]["w"] and new_state["m"]["z"] is state["m"]["z"]


@pytest.mark.parametrize("name,args", [
    ("cosine_schedule", dict(peak_lr=3e-4, warmup=10, total=100)),
    ("cosine_schedule", dict(peak_lr=1e-3, warmup=0, total=50, floor_frac=0.0)),
    ("wsd_schedule", dict(peak_lr=3e-4, warmup=10, stable=70, decay=20)),
    ("constant_schedule", dict(lr_val=2e-4)),
])
def test_schedules(name, args):
    ref, port = getattr(ref_opt, name)(**args), getattr(opt, name)(**args)
    for s in STEPS:
        np.testing.assert_allclose(port(s), float(ref(s)), rtol=TOL, atol=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm(max_norm):
    g = _tree(3)
    want, want_norm = ref_opt.clip_by_global_norm(_jax(g), max_norm)
    got, norm = opt.clip_by_global_norm(_torch(g), max_norm)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=TOL)
    np.testing.assert_allclose(float(opt.global_norm(_torch(g))), float(want_norm), rtol=TOL)
    _close(got, want)


def test_state_schema_matches_reference():
    from repro.models import get_model as ref_get_model
    from repro.models.layers import is_spec as ref_is_spec
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.models import get_model

    cfg = small_config("rwkv6-1.6b")
    want = ref_opt.make_optimizer(cfg).state_schema(ref_get_model(cfg).schema)
    want = {"/".join(k.key for k in kp): (s.shape, s.dtype) for kp, s in
            jax.tree_util.tree_flatten_with_path(want, is_leaf=ref_is_spec)[0]}
    pcfg = port_config(cfg)
    got = opt.make_optimizer(pcfg).state_schema(get_model(pcfg).schema)
    assert {k: (s.shape, s.dtype) for k, s in flatten(got).items()} == want


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "minicpm-2b"])
def test_make_optimizer_schedule(arch):
    cfg = get_config(arch)
    ref_cfg = small_config(arch)
    port, ref = opt.make_optimizer(cfg, total_steps=200), ref_opt.make_optimizer(ref_cfg, 200)
    tp, jp = _torch(_tree(4)), _jax(_tree(4))
    g = _tree(5)
    tp, _ = port.update(_torch(g), port.init(tp), tp)
    jp, _ = ref.update(_jax(g), ref.init(jp), jp)
    _close(tp, jp)


def test_adafactor_waits():
    """Adafactor no longer waits: ``make_optimizer`` routes the configs
    that ask for it (qwen2-72b, grok-1) to the port's adafactor, whose
    state is the reference's ``{"stats", "count"}``."""
    for arch in ("qwen2-72b", "grok-1-314b"):
        cfg = get_config(arch)
        assert cfg.optimizer == "adafactor"
        o = opt.make_optimizer(cfg)
        tree = _torch(_tree(0))
        assert sorted(o.init(tree)) == ["count", "stats"]


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # below / above the clip norm of 1
def test_adafactor_five_updates(grad_scale):
    """Five Adafactor updates against the reference's on factored (the
    (6, 5) and stacked (2, 4, 3) leaves), unfactored (1-d, and a dim of 1)
    and scalar leaves: parameters and every moment at 1e-6."""
    sched_args = dict(peak_lr=1e-2, warmup=2, total=10)
    ref = ref_opt.adafactor(ref_opt.cosine_schedule(**sched_args))
    port = opt.adafactor(opt.cosine_schedule(**sched_args))

    def tree(seed, scale=1.0):
        t = _tree(seed, scale)
        rng = np.random.default_rng(seed + 100)
        t["thin"] = (scale * rng.standard_normal((1, 6))).astype(np.float32)
        t["scalar"] = np.array(scale * rng.standard_normal(), np.float32)
        return t

    jp, tp = _jax(tree(0)), _torch(tree(0))
    jstate, tstate = ref.init(jp), port.init(tp)
    assert sorted(flatten(tstate["stats"])) == sorted(
        "/".join(k.key for k in kp)
        for kp, _ in jax.tree_util.tree_flatten_with_path(jstate["stats"])[0])
    for i in range(5):
        g = tree(10 + i, grad_scale)
        jp, jstate = ref.update(_jax(g), jstate, jp)
        tp, tstate = port.update(_torch(g), tstate, tp)
        _close(tp, jp)
        _close(tstate["stats"], jstate["stats"])
        assert int(tstate["count"]) == int(jstate["count"]) == i + 1


def test_adafactor_state_schema_matches_reference():
    from repro.models import get_model as ref_get_model
    from repro.models.layers import is_spec as ref_is_spec
    from repro_torch.models import get_model

    for arch in ("qwen2-72b", "grok-1-314b"):
        cfg = small_config(arch)
        want = ref_opt.make_optimizer(cfg).state_schema(ref_get_model(cfg).schema)
        want = {"/".join(k.key for k in kp): (s.shape, s.dtype) for kp, s in
                jax.tree_util.tree_flatten_with_path(want, is_leaf=ref_is_spec)[0]}
        pcfg = port_config(cfg)
        got = opt.make_optimizer(pcfg).state_schema(get_model(pcfg).schema)
        assert {k: (s.shape, s.dtype) for k, s in flatten(got).items()} == want
        assert any(k.endswith("/vr") for k in want) and any(k.endswith("/v") for k in want)
