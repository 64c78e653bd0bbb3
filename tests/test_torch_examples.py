"""The entry points of ``examples/`` in the port (``repro_torch.launch``):
``burst_plan_demo`` prints the reference example's text when both plan on
the same hardware, ``train_lm`` trains (falling losses) with the reference's
~100M config, ``serve_lm`` prints the reference's cache size."""
import importlib.util
import pathlib

import pytest

import repro.core.costmodel as ref_costmodel
import repro.core.planner as ref_planner
import repro.models.api as ref_api
import repro.serve.kvcache as ref_kvcache
from repro.configs import get_config as ref_get_config
from repro.configs.base import ModelConfig as RefModelConfig
import repro_torch.core.costmodel as port_costmodel
import repro_torch.core.planner as port_planner
from repro_torch.launch import burst_plan_demo, serve_lm, train_lm

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_burst_plan_demo_prints_the_reference_text(monkeypatch, capsys):
    """Both planners' default ``Hardware()`` patched to the paper's A100
    (the port's default is an H100, the reference's its TPU entry)."""
    monkeypatch.setattr(ref_planner, "Hardware", lambda: ref_costmodel.A100)
    monkeypatch.setattr(port_planner, "Hardware", lambda: port_costmodel.A100)
    _reference_example("burst_plan_demo").main()
    want = capsys.readouterr().out
    burst_plan_demo.main([])
    got = capsys.readouterr().out
    assert got == want
    assert "per-stage detail for zamba2-2.7b" in got and "enc-dec cross-edge plan" in got


def test_train_lm_fast_losses_fall(tmp_path, capsys):
    report = train_lm.main(["--fast", "--steps", "3", "--device", "cpu",
                            "--ckpt-dir", str(tmp_path / "ckpt")])
    assert report.steps_done == 3 and report.losses[-1] < report.losses[0]
    out = capsys.readouterr().out
    assert "steps=3 restarts=0" in out and "loss: " in out


def test_train_lm_100m_config_is_the_reference_example_s():
    """The reference builds it inside its ``main``: the same fields give
    the same parameter count and the same report line."""
    ref = RefModelConfig(
        name="llama-100m", family="dense", block_type="attn_mlp",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
        d_head=64, d_ff=2048, vocab_size=32000, rope_theta=1e4,
        tie_embeddings=True, attn_tp=False, kv_tp=False,
    )
    cfg = train_lm.config_100m()
    assert cfg.n_params() == ref.n_params()
    assert f"model: {cfg.n_params()/1e6:.0f}M params" == "model: 100M params"


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-1.6b"])
def test_serve_lm_prints_the_reference_cache_size(arch, capsys):
    out, eng = serve_lm.main(["--arch", arch, "--device", "cpu", "--new-tokens", "4"])
    assert out.shape == (4, 4)
    rcfg = ref_get_config(arch).reduced()
    capacity = 16 + 4 + 8
    want = (f"{rcfg.name}: cache "
            f"{ref_kvcache.cache_bytes(ref_api.get_model(rcfg), 4, capacity)/1e6:.1f} MB "
            f"for batch=4 capacity={capacity}")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == want
    assert lines[1] == "generated 4 tokens x 4 sequences"
