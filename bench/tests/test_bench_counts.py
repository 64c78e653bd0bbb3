"""The benchmark's counts: each configuration's model-FLOP formula against
``FlopCounterMode`` over the plain reference's forward, the roofline
counts against the formulas the port's kernels register, and the
reference's fast forms against its exact ones."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import counts, data
from bench.reference import qwen2, wkv6
from bench.reference.common import Precision, make_leaf, nest
from bench.reference.train import model_module
from bench.trace import Trace

BENCH = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).resolve().parent / "fixtures"
FORMULA_OF = {"tiny-rwkv6": "rwkv6-1.6b", "tiny-qwen2": "qwen2-1.5b"}


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem.replace("-", "_").replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(1, 8), (2, 16), (2, 33)])
@pytest.mark.parametrize("tiny", sorted(FORMULA_OF))
def test_model_flops_formula_counts_the_reference_forward(tiny, shape):
    """Three times the formula is the step's model FLOPs; the formula
    itself equals what FlopCounterMode counts over the plain reference's
    forward (WKV-6 step by step, attention row by row over its live keys)."""
    config = json.loads((FIXTURES / "configs" / f"{tiny}.json").read_text())
    m = config["model"]
    B, S = shape
    specs = model_module(config).schema(m)
    params = nest({p: make_leaf(s, 3, p, "cpu") for p, s in specs.items()})
    batch = data.train_batch({"batch": B, "seq": S, "tokens": {"law": "power", "exponent": 3}},
                             m["vocab_size"], 3, 0, "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model_module(config).loss(params, batch, m, Precision("fp32"), exact=True)
    formula = _load(BENCH / "flops" / f"{FORMULA_OF[tiny]}.py").forward_flops
    assert fc.get_total_flops() == formula(m, B, S)


def test_the_published_configurations_have_their_formulas():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        config = json.loads((BENCH.parent / c["file"]).read_text())
        fwd = _load(BENCH / "flops" / f"{c['name']}.py").forward_flops
        assert fwd(config["model"], 4, 4096) > 0


WKV_SHAPES = [(1, 1, 1, 32), (2, 100, 4, 64), (4, 4096, 32, 64), (1, 4096, 32, 64), (3, 65, 2, 64)]


@pytest.mark.parametrize("shape", WKV_SHAPES)
def test_wkv6_counts_are_the_registered_formulas(shape):
    from repro_torch.kernels import wkv6 as wk

    B, S, H, N = shape
    for backward in (False, True):
        assert counts.wkv6_chunk_flops(*shape, backward=backward) == \
            wk.chunk_flops(*shape, backward=backward)
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")  # noqa: E731
    r, k, v, w = (meta(B, S, H, N) for _ in range(4))
    u = torch.empty((H, N), dtype=torch.float32, device="meta")
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.wkv6_chunk_fwd(r, k, v, w, u, None)
    assert fc.get_total_flops() == counts.wkv6_chunk_flops(*shape)


FLASH_SHAPES = [(4, 4096, 4096, 12, 2, 128, True, 0), (1, 129, 129, 4, 4, 64, True, 0),
                (2, 100, 300, 4, 1, 80, False, 0), (1, 257, 257, 8, 2, 32, True, 96)]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_counts_are_the_registered_formulas(shape):
    from repro_torch.kernels import flash_attention as fa

    B, Sq, Skv, H, KV, d, causal, window = shape
    assert counts.attention_pairs(Sq, Skv, causal, window) == \
        fa.attention_pairs(Sq, Skv, causal, window)
    assert counts.flash_flops(B, Sq, Skv, H, d, causal, window) == \
        fa.flops_fwd(B, Sq, Skv, H, d, causal, window)
    assert counts.flash_flops(B, Sq, Skv, H, d, causal, window, backward=True) == \
        fa.flops_bwd(B, Sq, Skv, H, d, causal, window)
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")  # noqa: E731
    q, k, v = meta(B, Sq, H, d), meta(B, Skv, KV, d), meta(B, Skv, KV, d)
    with FlopCounterMode(display=False) as fc:
        o, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal, window, 0.0, True)
    assert fc.get_total_flops() == counts.flash_flops(B, Sq, Skv, H, d, causal, window)
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.flash_attention_bwd(q, k, v, o, o, lse, causal, window, 0.0)
    assert fc.get_total_flops() == counts.flash_flops(B, Sq, Skv, H, d, causal, window,
                                                      backward=True)


def test_wkv6_bytes_are_chip_smokes():
    import chip_smoke

    for shape in WKV_SHAPES:
        assert counts.wkv6_bytes(*shape) == chip_smoke._wkv_bytes(*shape)


def test_least_time_takes_the_larger_bound():
    assert counts.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert counts.least_seconds(989e12, 6.7e12) == pytest.approx(2.0)


def _run(config, traffic, ops):
    from types import SimpleNamespace

    cell = SimpleNamespace(config={"model": config}, traffic=traffic)
    tr = Trace(ops=ops, busy_s=sum(s for _, s in ops), window_s=1.0, gaps=[])
    return SimpleNamespace(cell=cell, trace=tr)


def test_roofline_readers_count_calls_from_the_trace():
    wkv = _load(BENCH / "metrics" / "wkv6_roofline_pct.py").read
    flash = _load(BENCH / "metrics" / "flash_roofline_pct.py").read
    m = {"num_heads": 32, "d_head": 64}
    tr = {"batch": 4, "seq": 4096}
    ops = [("void wkv6_chunk_state_kernel<64, false>(x)", 1e-4),
           ("void wkv6_chunk_out_kernel<64>(x)", 1e-3),
           ("void wkv6_chunk_walk_kernel<64>(x)", 2e-3)]
    f_b, b_b = counts.wkv6_bytes(4, 4096, 32, 64)
    want = (counts.least_seconds(counts.wkv6_chunk_flops(4, 4096, 32, 64), f_b)
            + counts.least_seconds(counts.wkv6_chunk_flops(4, 4096, 32, 64, True), b_b))
    assert wkv(_run(m, tr, ops)) == pytest.approx(100 * want / 3.1e-3)
    assert wkv(_run(m, tr, [("gemm", 1.0)])) is None  # nothing to read: no value, never 0
    assert flash(_run(m, tr, ops)) is None
    qm = {"num_heads": 12, "num_kv_heads": 2, "d_head": 128}
    fops = [("void flash_fwd_sm90<128, false>(x)", 5e-4),
            ("void flash_bwd_dq_sm90<128, false>(x)", 1e-3),
            ("void flash_bwd_dkdv_sm90<128, false>(x)", 1e-3)]
    f_b, b_b = counts.flash_bytes(4, 4096, 4096, 12, 2, 128)
    want = (counts.least_seconds(counts.flash_flops(4, 4096, 4096, 12, 128, True, 0), f_b)
            + counts.least_seconds(counts.flash_flops(4, 4096, 4096, 12, 128, True, 0, True),
                                   b_b))
    assert flash(_run(qm, tr, fops)) == pytest.approx(100 * want / 2.5e-3)


def test_wkv6_chunked_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    B, S, H, N = 2, 37, 3, 8
    r, k, v = (torch.randn((B, S, H, N), generator=g) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((B, S, H, N), generator=g)))
    u = torch.randn((H, N), generator=g)
    np.testing.assert_allclose(wkv6.wkv6_chunked(r, k, v, w, u), wkv6.wkv6_steps(r, k, v, w, u),
                               rtol=1e-4, atol=1e-5)


def test_blocked_attention_is_the_exact_one(monkeypatch):
    monkeypatch.setattr(qwen2, "BLOCK_Q", 4)
    g = torch.Generator().manual_seed(1)
    q = torch.randn((2, 11, 4, 8), generator=g)
    k, v = (torch.randn((2, 11, 2, 8), generator=g) for _ in range(2))
    np.testing.assert_allclose(qwen2.attention(q, k, v), qwen2.attention(q, k, v, exact=True),
                               rtol=1e-5, atol=1e-6)
