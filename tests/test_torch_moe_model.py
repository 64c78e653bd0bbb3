"""The MoE family (qwen3-moe-30b-a3b, grok-1-314b with its 30.0 logit
softcap) and Adafactor training in the port against the reference.

On bridged weights, fp32, reduced configs: loss, ``moe_aux`` and every
parameter gradient against ``jax.value_and_grad(api.loss)`` called
outside any ``fsdp.context`` (ROADMAP Queue 3), losses to 1e-5 relative
and gradients to 1e-5 relative plus 1e-5 of each leaf's largest
magnitude; ``forward``, ``prefill`` (logits and cache) and three
``decode_step``s against the reference's at 1e-5; a 5-step trajectory of
reduced qwen2-72b and grok-1 through the jitted reference train step,
with Adafactor (the tolerances of ``tests/test_torch_train.py``); and the
training CLI for both Adafactor archs and qwen3-moe, whose burst plan of
the full config must equal the reference planner's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_model as ref_get_model
from repro_torch.models import get_model
from test_torch_bridge import bridged, port_config, small_config
from test_torch_train import _batch, _step_and_trajectory
from test_torch_transformer_train import LOSS_TOL, _assert_grads, _loss_and_grads

TOL = 1e-5
ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_grads_match_reference(arch):
    cfg = small_config(arch)
    assert cfg.block_type == "moe"
    (jl, jg), (tl, tg), metrics = _loss_and_grads(cfg)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL)
    _assert_grads(tg, jg)
    jp, _ = bridged(cfg)
    jb, _ = _batch(cfg, 0)
    _, jm = ref_get_model(cfg).loss(jp, jb)
    aux = metrics["moe_aux"]
    assert aux.dtype == torch.float32 and float(aux.detach()) > 0.0
    np.testing.assert_allclose(float(aux.detach()), float(jm["moe_aux"]), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(metrics["xent"].detach()), float(jm["xent"]),
                               rtol=LOSS_TOL)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = small_config(request.param)
    jparams, tparams = bridged(cfg)
    return cfg, ref_get_model(cfg), get_model(port_config(cfg)), jparams, tparams


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def test_forward_logits(model):
    cfg, ref, port, jp, tp = model
    toks = _tokens(cfg, 2, 9, 0)
    _close(port.forward(tp, torch.from_numpy(toks)), jax.jit(ref.forward)(jp, jnp.asarray(toks)))


@pytest.mark.parametrize("per_row", [False, True])
def test_prefill_and_three_decode_steps(model, per_row):
    cfg, ref, port, jp, tp = model
    toks = _tokens(cfg, 2, 11, 1)
    want_logits, jcache = jax.jit(ref.prefill, static_argnums=2)(jp, jnp.asarray(toks), 16)
    logits, tcache = port.prefill(tp, torch.from_numpy(toks), 16)
    _close(logits, want_logits)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])
    lens = np.array([11, 6], np.int32) if per_row else np.int32(11)
    feed = _tokens(cfg, 2, 3, 3)
    decode = jax.jit(ref.decode_step)
    for i in range(3):
        tok = feed[:, i:i + 1]
        want, jcache = decode(jp, jnp.asarray(tok), jcache, jnp.asarray(lens + i))
        got, tcache = port.decode_step(tp, torch.from_numpy(tok), tcache,
                                       torch.as_tensor(lens + i))
        _close(got, want)


@pytest.mark.parametrize("arch", ["qwen2-72b", "grok-1-314b"])
def test_adafactor_train_step_and_trajectory(arch):
    """One Adafactor step (every parameter and factored moment) and 5 steps
    of losses against the reference's jitted train step."""
    cfg = small_config(arch)
    assert cfg.optimizer == "adafactor"
    _step_and_trajectory(cfg)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b", "qwen2-72b"])
def test_train_cli_trains_moe_and_adafactor_on_cpu(arch, capsys):
    from repro_torch.launch import train as train_cli

    train_cli.main(["--arch", arch, "--steps", "3", "--batch", "2", "--seq", "16",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("BurstPlan G=256 amp_limit=2 ")
    last = out.strip().splitlines()[-1]
    assert last.startswith("done on cpu: steps=3 loss ")
    first, final = (float(x) for x in last.split("loss ")[1].split(" restarts")[0].split(" -> "))
    assert np.isfinite([first, final]).all()


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b"])
def test_moe_burst_plan_equals_the_reference_planners(arch):
    """The plan ``launch/train.py`` prints for the full config (``TRAIN_4K``
    on 256 simulated H100s: the coordinator's default hardware) is the
    reference planner's for the reference's graph on the same hardware,
    MoE layers included."""
    import dataclasses

    from repro.configs import TRAIN_4K as REF_TRAIN_4K
    from repro.configs import get_config as ref_get_config
    from repro.core import costmodel as ref_costmodel
    from repro.core import planner as ref_planner
    from repro.models import graph as ref_graph
    from repro_torch.configs import TRAIN_4K, get_config
    from repro_torch.core.coordinator import ClusterCoordinator, Job
    from repro_torch.models.graph import build_lm_graph
    from test_torch_planner import _same_plan, plain

    port_g = build_lm_graph(get_config(arch), TRAIN_4K)
    ref_g = ref_graph.build_lm_graph(ref_get_config(arch), REF_TRAIN_4K)
    assert plain(port_g) == plain(ref_g)
    assert any(getattr(n, "kind", None) == "moe" for n in port_g)
    coord = ClusterCoordinator(256)
    got = coord.submit_foreground(Job(arch, "foreground", port_g, amp_limit=2.0))
    want = ref_planner.plan(ref_g, 256, amp_limit=2.0,
                            hw=ref_costmodel.Hardware(**dataclasses.asdict(coord.hw)))
    _same_plan(got, want)
