"""The port's training path against the reference's, on the CPU.

Data batches (bit-identical per (seed, step), and after ``restore``), the
train state, one train step and a 5-step loss trajectory against the
reference's ``jax.jit(make_train_step(api, opt))`` run outside any
``fsdp.context`` (the reference's ``jit_train_step`` fails on this JAX; see
ROADMAP Queue 3), checkpoints read both ways, the fault-tolerant loop, the
CLI, and the refusals.  Reduced rwkv6-1.6b and zamba2-2.7b in fp32:
losses and AdamW moments agree to 1e-5; parameters after the first step to a tenth of its
learning rate, because Adam's first update is ``lr * g / |g|`` per element,
so an element whose gradient is near zero moves by a part of ``lr`` on
rounding noise in ``g``.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.data.pipeline import SyntheticLMData as RefData
from repro.models import get_model as ref_get_model
from repro.optim.optimizer import make_optimizer as ref_make_optimizer
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.checkpoint import ckpt
from repro_torch.configs import TRAIN_4K
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.dist.faults import MitigationLog, StepTimer
from repro_torch.models import get_model
from repro_torch.models.layers import tree_leaves
from repro_torch.optim.optimizer import make_optimizer
from repro_torch.train.loop import TrainConfig, train
from repro_torch.train.state import init_state, state_schema
from repro_torch.train.step import make_forward, make_train_step
from test_torch_bridge import bridged, port_config, small_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5
MOMENT_TOL = 1e-5
PARAM_ATOL = 0.1 * 3e-4  # a tenth of the first step's learning rate (cosine, no warmup)


def _cfg(**kw):
    return small_config("rwkv6-1.6b", **kw)


@pytest.mark.parametrize("seed,start", [(0, 0), (0, 7), (3, 2), (12345, 100)])
def test_data_bit_identical(seed, start):
    cfg = _cfg()
    ref = RefData(cfg, 3, 16, seed=seed, start_step=start)
    port = SyntheticLMData(port_config(cfg), 3, 16, seed=seed, start_step=start, device="cpu")
    try:
        for _ in range(3):
            want, got = next(ref), next(port)
            assert sorted(got) == sorted(want) == ["labels", "tokens"]
            for k in want:
                assert got[k].dtype == torch.int64
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert port.state() == ref.state() == {"seed": seed, "step": start + 3}
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "pixtral-12b"])
def test_data_refuses_unported_batch_kinds(arch):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_host_batch

    with pytest.raises(NotImplementedError, match="not ported"):
        make_host_batch(get_config(arch).reduced(), 1, 8, seed=0, step=0)


def test_data_restore():
    cfg = port_config(_cfg())
    data = SyntheticLMData(cfg, 2, 8, seed=1, device="cpu")
    first = [next(data) for _ in range(4)]
    data.restore({"seed": 1, "step": 1})  # backwards: batches made ahead are dropped
    again = [next(data) for _ in range(3)]
    data.restore({"seed": 1, "step": 9})  # forwards
    later = next(data)
    data.close()
    for a, b in zip(first[1:], again):
        assert torch.equal(a["tokens"], b["tokens"])
    fresh = SyntheticLMData(cfg, 2, 8, seed=1, start_step=9, device="cpu")
    assert torch.equal(later["tokens"], next(fresh)["tokens"])
    fresh.close()


def _states(cfg, seed=0):
    """(reference state, port state) with bridged params, fresh optimizer."""
    jp, tp = bridged(cfg, seed)
    ropt, popt = ref_make_optimizer(cfg, 5), make_optimizer(port_config(cfg), 5)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    jstate = {"params": jp, "opt": ropt.init(jp), "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tp, "opt": popt.init(tp), "step": torch.zeros((), dtype=torch.int32)}
    return ropt, popt, jstate, tstate


def _batch(cfg, step, B=2, S=32):
    from repro_torch.data.pipeline import make_host_batch

    hb = make_host_batch(cfg, B, S, seed=0, step=step)
    return ({k: jnp.asarray(v) for k, v in hb.items()},
            {k: torch.from_numpy(v).long() for k, v in hb.items()})


def test_train_step_and_trajectory():
    _step_and_trajectory(_cfg())


def test_hybrid_train_step_and_trajectory():
    """zamba2: the shared attention block (through the flash kernel's plain
    version on the CPU) and the SSD scan train as the reference's do.
    Some of its weights get gradients that cancel to rounding noise (below
    1e-5 of the leaf's largest, measured): Adam's first step moves those by
    up to the full ``lr`` in the sign of that noise, which differs between
    runs on the CPU.  Such elements, whose reference first moment is below
    ``NOISE_FLOOR`` of the leaf's largest, are held to ``2 lr``; the rest to
    a tenth of ``lr``, and the moments themselves to 1e-5 everywhere."""
    _step_and_trajectory(small_config("zamba2-2.7b"), noise_floor=NOISE_FLOOR)


NOISE_FLOOR = 1e-4


def _step_and_trajectory(cfg, noise_floor=None):
    ropt, popt, jstate, tstate = _states(cfg)
    ref_step = jax.jit(ref_make_train_step(ref_get_model(cfg), ropt))
    port_step = make_train_step(get_model(port_config(cfg)), popt)
    for i in range(5):
        jb, tb = _batch(cfg, i)
        jstate, jm = ref_step(jstate, jb)
        tstate, tm = port_step(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_TOL)
        if i == 0:  # one step: every parameter and moment
            moments = {k: np.abs(np.asarray(v)) for k, v in
                       ref_ckpt._flatten(jstate["opt"]).items() if k.startswith("m/")}
            for key, atol in (("params", PARAM_ATOL), ("opt", MOMENT_TOL)):
                got = ckpt.flatten(tstate[key])
                want = {k: np.asarray(v) for k, v in ref_ckpt._flatten(jstate[key]).items()}
                assert sorted(got) == sorted(want)
                for k, w in want.items():
                    g = got[k].detach().numpy()
                    if key == "params" and noise_floor is not None:
                        m = moments["m/" + k]
                        tol = np.where(m < noise_floor * m.max(), 2 * 3e-4, atol)
                        bad = np.abs(g - w) > tol + MOMENT_TOL * np.abs(w)
                        assert not bad.any(), (k, np.abs(g - w)[bad].max(), int(bad.sum()))
                    else:
                        np.testing.assert_allclose(g, w, atol=atol, rtol=MOMENT_TOL, err_msg=k)
    assert int(tstate["step"]) == int(jstate["step"]) == 5


def test_init_state_and_schema():
    cfg = port_config(_cfg())
    api, opt = get_model(cfg), make_optimizer(cfg)
    state = init_state(api, opt, torch.Generator().manual_seed(0), "cpu")
    schema = ckpt.flatten(state_schema(api, opt))
    got = ckpt.flatten(state)
    assert sorted(got) == sorted(schema)
    for k, spec in schema.items():
        assert tuple(got[k].shape) == spec.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == spec.dtype, k
    assert all(p.requires_grad for p in tree_leaves(state["params"]))
    logits = make_forward(api)(state["params"], {"tokens": torch.zeros((1, 5), dtype=torch.long)})
    assert logits.shape == (1, 5, cfg.padded_vocab)


def test_checkpoints_load_both_ways(tmp_path):
    cfg = _cfg()
    ropt, popt, jstate, tstate = _states(cfg, seed=3)
    # port -> reference
    ckpt.save(str(tmp_path / "p"), tstate, 4, async_=False, extra_meta={"data": {"step": 4}})
    got, meta = ref_ckpt.restore(str(tmp_path / "p"), jstate)
    assert meta["step"] == 4 and meta["data"] == {"step": 4}
    want = ckpt.flatten(tstate)
    for k, v in ref_ckpt._flatten(got).items():
        np.testing.assert_array_equal(np.asarray(v), want[k].detach().numpy(), err_msg=k)
    # reference -> port
    ref_ckpt.save(str(tmp_path / "r"), jstate, 6, async_=False)
    restored, meta = ckpt.restore(str(tmp_path / "r"), tstate)
    assert meta["step"] == 6
    for k, v in ref_ckpt._flatten(jstate).items():
        t = ckpt.flatten(restored)[k]
        assert t.dtype == ckpt.flatten(tstate)[k].dtype
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(v), err_msg=k)
    assert all(p.requires_grad for p in tree_leaves(restored["params"]))


def test_checkpoint_keep_and_shape_check(tmp_path):
    tree = {"a": torch.ones(3), "b": {"c": torch.zeros((2, 2), dtype=torch.int32)}}
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), tree, s, keep=2).join()
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003", "step_0000000004"]
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"a": torch.ones(4), "b": {"c": tree["b"]["c"]}})
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.save(str(tmp_path), {"x": torch.ones(2, dtype=torch.bfloat16)}, 5)


def _shape(batch=2, seq=16):
    return dataclasses.replace(TRAIN_4K, seq_len=seq, global_batch=batch, name="t")


def test_loop_restart_after_fault_reproduces_clean_run(tmp_path):
    cfg = port_config(_cfg())
    clean = train(cfg, _shape(), TrainConfig(steps=6), device="cpu")
    assert clean.steps_done == 6 and clean.restarts == 0
    fired = []

    def injector(step):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("injected fault")

    tc = TrainConfig(steps=6, ckpt_dir=str(tmp_path), ckpt_every=2)
    faulty = train(cfg, _shape(), tc, fault_injector=injector, device="cpu")
    assert faulty.restarts == 1 and faulty.mitigations.count("failure") == 1
    # steps 0-2 ran, the fault hit before step 3, the loop restored step 2
    np.testing.assert_allclose(faulty.losses, clean.losses[:3] + clean.losses[2:], rtol=1e-6)
    # a second run finds the finished checkpoint and has nothing left to do
    again = train(cfg, _shape(), tc, device="cpu")
    assert again.restarts == 1 and again.steps_done == 0


def test_loop_loss_decreases_and_gives_up_after_max_failures():
    cfg = port_config(_cfg())
    rep = train(cfg, _shape(4, 32), TrainConfig(steps=12), device="cpu")
    assert np.isfinite(rep.losses).all() and rep.losses[-1] < rep.losses[0]
    assert len(rep.step_times) == 12

    def always(step):
        raise ValueError("broken")

    with pytest.raises(ValueError, match="broken"):
        train(cfg, _shape(), TrainConfig(steps=2, max_failures=1), fault_injector=always,
              device="cpu")


@pytest.mark.parametrize("field,value", [
    ("bg_step_fn", lambda: None), ("coordinator", object()), ("heartbeat", object()),
    ("transport", object()), ("control_loop", object()), ("lease", object()),
    ("apply_reconfig", True), ("admit_every", 5)])
def test_loop_refuses_unported_options(field, value):
    tc = TrainConfig(steps=1, **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train(port_config(_cfg()), _shape(), tc, device="cpu")


def test_step_timer_and_log():
    timer, log = StepTimer(deadline_factor=2.0, warmup_steps=3), MitigationLog()
    for dt in (1.0, 1.0, 1.0):
        timer.record(dt)
    assert timer.deadline() == pytest.approx(2.0)
    assert timer.is_straggler_step(2.5) and not timer.is_straggler_step(1.5)
    timer.record(10.0)  # a straggler does not move the EMA
    assert timer.ema == pytest.approx(1.0)
    log.log("straggler", step=3)
    assert log.count("straggler") == 1 and len(log) == 1
    with pytest.raises(ValueError):
        StepTimer(deadline_factor=1.0)


def test_attn_mlp_training_and_rwkv_serving_wait():
    from repro_torch.serve.engine import ServingEngine

    llama = port_config(small_config("llama3-8b"))
    api = get_model(llama)
    assert api.loss is None
    with pytest.raises(NotImplementedError, match="loss_fn"):
        make_train_step(api, make_optimizer(llama))
    with pytest.raises(NotImplementedError, match="serving"):
        ServingEngine(port_config(_cfg()), {}, batch=1, capacity=8, device="cpu")


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config(_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, _shape(), TrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLMData(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(get_model(cfg), make_optimizer(cfg), torch.Generator())


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_cli_trains_on_cpu(tmp_path, arch):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--steps", "3", "--batch", "2", "--seq", "16", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "done on cpu: steps=3" in out.stdout
    assert ckpt.latest_step(str(tmp_path)) is None  # ckpt_every 10 > 3 steps
