"""Training the ``attn_mlp`` family in the port against the reference, on
the CPU, and the port's quickstart.

Loss and every parameter gradient of reduced llama3-8b, qwen2-1.5b (QKV
bias, tied embeddings; also with its own 12 query heads over 2 KV heads,
a group of 6) and minicpm-2b against ``jax.value_and_grad(api.loss)`` on
bridged weights, called outside any ``fsdp.context`` (ROADMAP Queue 3);
a 5-step AdamW trajectory (WSD for minicpm) against the reference's
jitted train step; and the three remat policies, which must give the
same loss and gradients as each other and as the reference's.  fp32
throughout: losses to 1e-5 relative and gradients to 1e-5 relative plus
1e-5 of each leaf's largest magnitude, the tolerances
``tests/test_torch_train.py`` holds rwkv6's losses and AdamW moments to.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.models import get_model as ref_get_model
from repro_torch.checkpoint import ckpt
from repro_torch.models import get_model
from repro_torch.models.layers import tree_leaves
from test_torch_bridge import bridged, port_config, small_config
from test_torch_train import _batch, _step_and_trajectory

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5

CONFIGS = {
    "llama3-8b": lambda **kw: small_config("llama3-8b", **kw),
    "qwen2-1.5b": lambda **kw: small_config("qwen2-1.5b", **kw),
    # qwen2's own grouping: 12 query heads over 2 KV heads (reduced() makes it 4/1)
    "qwen2-1.5b-12/2": lambda **kw: small_config("qwen2-1.5b", num_heads=12, num_kv_heads=2,
                                                 d_head=16, **kw),
    "minicpm-2b": lambda **kw: small_config("minicpm-2b", **kw),
}


def _loss_and_grads(cfg, seed=0, B=2, S=32):
    """(reference loss, {leaf: grad}), (port loss, {leaf: grad}) on bridged weights."""
    jp, tp = bridged(cfg, seed)
    jb, tb = _batch(cfg, 0, B, S)
    (jl, _), jg = jax.jit(jax.value_and_grad(ref_get_model(cfg).loss, has_aux=True))(jp, jb)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    tl, metrics = get_model(port_config(cfg)).loss(tp, tb)
    grads = torch.autograd.grad(tl, leaves)
    names = list(ckpt.flatten(tp))  # flatten walks tree_leaves' order
    want = {k: np.asarray(v) for k, v in ref_ckpt._flatten(jg).items()}
    return (float(jl), want), (float(tl.detach()), dict(zip(names, grads))), metrics


def _assert_grads(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].detach().numpy()
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_grads_match_reference(name):
    cfg = CONFIGS[name]()
    (jl, jg), (tl, tg), metrics = _loss_and_grads(cfg)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL)
    _assert_grads(tg, jg)
    assert sorted(metrics) == ["loss", "moe_aux", "xent"]
    assert metrics["moe_aux"].dtype == torch.float32 and float(metrics["moe_aux"]) == 0.0
    assert float(metrics["xent"].detach()) == float(metrics["loss"].detach())


def test_masked_labels_match_reference():
    """Labels of -1 drop out of the mean, as in the reference."""
    cfg = CONFIGS["qwen2-1.5b"]()
    jp, tp = bridged(cfg, 1)
    jb, tb = _batch(cfg, 3)
    labels = np.asarray(jb["labels"]).copy()
    labels[:, ::3] = -1
    jb = {**jb, "labels": jax.numpy.asarray(labels)}
    tb = {**tb, "labels": torch.from_numpy(labels).long()}
    jl, _ = ref_get_model(cfg).loss(jp, jb)
    tl, _ = get_model(port_config(cfg)).loss(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL)


@pytest.mark.parametrize("name", ["qwen2-1.5b-12/2", "minicpm-2b"])
def test_train_step_and_trajectory(name):
    """One AdamW step (every parameter and moment) and 5 steps of losses
    against the reference's jitted train step; minicpm on WSD."""
    _step_and_trajectory(CONFIGS[name]())


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
def test_remat_policies_agree(policy):
    """Each remat policy gives the reference's loss and gradients (under
    the same policy) and exactly the port's ``none`` ones."""
    cfg = CONFIGS["qwen2-1.5b-12/2"](remat_policy=policy)
    (jl, jg), (tl, tg), _ = _loss_and_grads(cfg)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL)
    _assert_grads(tg, jg)
    _, (nl, ng), _ = _loss_and_grads(dataclasses.replace(cfg, remat_policy="none"))
    assert tl == nl
    for k in ng:
        assert torch.equal(tg[k], ng[k]), k


def test_dots_policy_saves_the_weight_products():
    """Under ``dots`` the backward recomputes no weight matmul: the forward
    of a checkpointed layer runs its mm's once, ``full`` runs them twice."""
    from torch.utils.flop_counter import FlopCounterMode

    counts = {}
    for policy in ("none", "full", "dots"):
        cfg = port_config(CONFIGS["llama3-8b"](remat_policy=policy))
        _, tp = bridged(CONFIGS["llama3-8b"](), 0)
        _, tb = _batch(CONFIGS["llama3-8b"](), 0)
        leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
        with FlopCounterMode(display=False) as fc:
            loss, _ = get_model(cfg).loss(tp, tb)
            torch.autograd.grad(loss, leaves)
        counts[policy] = fc.get_flop_counts()["Global"][torch.ops.aten.mm]
    assert counts["dots"] == counts["none"] < counts["full"]


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-1.6b", "zamba2-2.7b"])
def test_unknown_remat_policy_raises(arch):
    """Every family's layer loop goes through ``layers.remat``, which
    refuses a policy it does not know."""
    cfg = port_config(small_config(arch, remat_policy="everything"))
    _, tp = bridged(small_config(arch), 0)
    _, tb = _batch(small_config(arch), 0)
    with pytest.raises(ValueError, match="remat_policy"):
        get_model(cfg).loss(tp, tb)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_dots_policy_in_the_other_families(arch):
    """``dots`` gives rwkv6 and zamba2 the ``none`` loss and gradients
    exactly, and saves their weight products as it does the transformer's."""
    from torch.utils.flop_counter import FlopCounterMode

    _, tb = _batch(small_config(arch), 0)
    out = {}
    for policy in ("none", "full", "dots"):
        _, tp = bridged(small_config(arch), 0)
        leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
        with FlopCounterMode(display=False) as fc:
            loss, _ = get_model(port_config(small_config(arch, remat_policy=policy))).loss(tp, tb)
            grads = torch.autograd.grad(loss, leaves)
        out[policy] = (float(loss.detach()), grads,
                       fc.get_flop_counts()["Global"][torch.ops.aten.mm])
    (nl, ng, nmm), (_, _, fmm), (dl, dg, dmm) = out["none"], out["full"], out["dots"]
    assert dl == nl
    assert all(torch.equal(a, b) for a, b in zip(dg, ng))
    assert dmm == nmm < fmm


def _run(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=timeout, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_quickstart_on_cpu():
    out = _run("repro_torch.launch.quickstart", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "=== llama3-8b: 8.0B params ==="
    assert any(l.startswith("BurstPlan G=256 amp_limit=2") for l in lines)
    assert any(l.startswith("idle gaps: ") for l in lines)
    assert any(l.startswith("collocation: fg_slowdown=") for l in lines)
    last = lines[-1]
    assert last.startswith("smoke train on cpu: loss ") and last.endswith("(10 steps)")
    first, final = (float(x) for x in last.split("loss ")[1].split(" (")[0].split(" -> "))
    assert np.isfinite([first, final]).all()


def test_quickstart_needs_a_card_unless_told_cpu(monkeypatch):
    from repro_torch.launch import quickstart

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])


def test_train_cli_prints_the_burst_plan_and_trains_attn_mlp():
    out = _run("repro_torch.launch.train", "--arch", "qwen2-1.5b", "--steps", "2",
               "--batch", "2", "--seq", "16", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("BurstPlan G=256 amp_limit=2 ")
    assert "done on cpu: steps=2" in out.stdout
