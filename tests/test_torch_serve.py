"""The port's serving stack against ``repro.serve`` on the same inputs.

Paged gather/scatter against the reference helpers, the allocator's
invariants, greedy tokens of the port's continuous engine equal to the
reference engine's over ``benchmarks/traces/requests_smoke.json`` (fp32,
reduced llama3-8b, bridged weights), and the port's continuous engine equal
to its fixed-batch engine, as the reference asserts of itself.  Every
decoder-only family through ``ServingEngine``: greedy tokens equal to the
reference engine's for reduced rwkv6-1.6b and zamba2-2.7b (prompts fed
token by token) and qwen3-moe-30b-a3b and grok-1-314b (fused prefill);
the continuous engine's for the MoE configs over the smoke trace; and the
serving CLI for each family.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import kvcache as ref_kv
from repro.serve.engine import ContinuousBatchingEngine as RefContinuous
from repro.serve.engine import ServingEngine as RefServing
from repro.serve.scheduler import ContinuousScheduler as RefScheduler
from repro.serve.trace import load_requests as ref_load_requests
from repro.models import get_model as ref_get_model
from repro_torch.models import get_model as port_get_model
from repro_torch.serve import kvcache as port_kv
from repro_torch.serve.engine import ContinuousBatchingEngine, ServingEngine
from repro_torch.serve.scheduler import ContinuousScheduler, Request
from repro_torch.serve.trace import load_requests
from test_torch_bridge import bridged, port_config, small_config

SMOKE_TRACE = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "traces",
                           "requests_smoke.json")


@pytest.fixture(scope="module")
def llama():
    cfg = small_config("llama3-8b")
    jparams, tparams = bridged(cfg)
    return cfg, port_config(cfg), jparams, tparams


def _pool_pair(cfg, n_pages, pt, seed):
    """Reference and port pools holding the same random KV."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, n_pages, pt, cfg.num_kv_heads, cfg.d_head)
    flat = {k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")}
    return ({k: jnp.asarray(v) for k, v in flat.items()},
            {k: torch.from_numpy(v.copy()) for k, v in flat.items()})


def _eq(got, want):
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_gather_view_matches_reference(llama):
    cfg = llama[0]
    jpool, tpool = _pool_pair(cfg, 9, 4, 0)
    tables = np.array([[3, 7, 1], [0, 0, 0], [8, 2, 0]], np.int32)
    want = ref_kv.gather_view(jpool, jnp.asarray(tables))
    got = port_kv.gather_view(tpool, torch.from_numpy(tables))
    _eq(got, want)


def test_scatter_token_matches_reference(llama):
    cfg = llama[0]
    jpool, tpool = _pool_pair(cfg, 9, 4, 1)
    tables = np.array([[3, 7], [0, 0], [5, 2]], np.int32)
    lens = np.array([5, 0, 2], np.int32)
    jview = jax.tree.map(lambda v: v + 1.0, ref_kv.gather_view(jpool, jnp.asarray(tables)))
    tview = port_kv.tree_map(lambda v: v + 1.0,
                             port_kv.gather_view(tpool, torch.from_numpy(tables)))
    want = ref_kv.scatter_token(jpool, jview, jnp.asarray(tables), jnp.asarray(lens))
    got = port_kv.scatter_token(tpool, tview, torch.from_numpy(tables),
                                torch.from_numpy(lens))
    assert got["k"] is tpool["k"]  # in place
    _eq(got, want)


def test_cache_to_pages_and_write_pages_match_reference(llama):
    cfg, tcfg, jparams, tparams = llama
    toks = np.arange(8, dtype=np.int32)[None, :]
    _, jcache = ref_get_model(cfg).prefill(jparams, jnp.asarray(toks), 8)
    _, tcache = port_get_model(tcfg).prefill(tparams, torch.from_numpy(toks), 8)
    jchunks, tchunks = ref_kv.cache_to_pages(jcache, 4), port_kv.cache_to_pages(tcache, 4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tchunks[key].numpy(), np.asarray(jchunks[key]),
                                   atol=1e-5, rtol=1e-5)
    jpool, tpool = _pool_pair(cfg, 9, 4, 2)
    want = ref_kv.write_pages(jpool, [5, 3], jchunks)
    got = port_kv.write_pages(tpool, [5, 3], tchunks)
    for key in ("k", "v"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, rtol=1e-5)
    assert port_kv.cache_bytes(port_get_model(tcfg), 3, 16) == ref_kv.cache_bytes(
        ref_get_model(cfg), 3, 16)


def test_page_allocator_invariants():
    a = port_kv.PageAllocator(6, 4)
    assert a.free_pages == 5 and a.pages_for(9) == 3
    p0 = a.alloc("r0", 9)
    assert p0 == [1, 2, 3] and port_kv.SCRATCH_PAGE not in p0
    assert a.alloc("r1", 9) is None  # only 2 pages left: deferred, not dropped
    assert a.grow("r0", 13) == [1, 2, 3, 4]
    with pytest.raises(ValueError):
        a.alloc("r0", 1)
    a.check_invariants()
    assert a.free("r0") == 4 and a.used_pages == 0
    assert a.alloc("r1", 9) == [4, 3, 2]  # LIFO: freed pages come back first
    a.check_invariants()
    with pytest.raises(ValueError):
        port_kv.PageAllocator(1, 4)


def _by_rid(report):
    return {r.rid: tuple(r.tokens) for r in report.completed}


def test_continuous_greedy_tokens_match_reference_engine(llama):
    cfg, tcfg, jparams, tparams = llama
    kw = dict(lanes=4, n_pages=25, page_tokens=4, lane_capacity=24)
    want = RefScheduler(RefContinuous(cfg, jparams, **kw)).run(
        ref_load_requests(SMOKE_TRACE))
    eng = ContinuousBatchingEngine(tcfg, tparams, debug_checks=True, device="cpu", **kw)
    got = ContinuousScheduler(eng).run(load_requests(SMOKE_TRACE))
    assert len(got.completed) == 24
    assert _by_rid(got) == _by_rid(want)
    assert eng.stats.prefills == 24 and eng.alloc.used_pages == 0


def test_continuous_matches_fixed_batch_greedy(llama):
    """Same prompts through the paged continuous engine and the contiguous
    fixed-batch engine produce identical greedy tokens."""
    _, tcfg, _, tparams = llama
    gen = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=gen.integers(0, tcfg.vocab_size, (6,), dtype=np.int32),
                    max_new_tokens=5) for i in range(2)]
    fixed = ServingEngine(tcfg, tparams, batch=2, capacity=32, device="cpu")
    want = fixed.generate(np.stack([r.prompt for r in reqs]), 5)
    eng = ContinuousBatchingEngine(tcfg, tparams, debug_checks=True, lanes=2, n_pages=17,
                                   page_tokens=4, lane_capacity=16, device="cpu")
    rep = ContinuousScheduler(eng).run(reqs)
    got = np.stack([np.array(r.tokens) for r in sorted(rep.completed, key=lambda r: r.rid)])
    np.testing.assert_array_equal(got, want)
    for r in rep.completed:
        assert r.arrival <= r.admitted_at <= r.first_token_at <= r.finished_at


def test_page_exhaustion_defers_and_oversize_rejected(llama):
    _, tcfg, _, tparams = llama
    gen = np.random.default_rng(6)
    reqs = [Request(rid=i, prompt=gen.integers(0, 512, (6,), dtype=np.int32),
                    max_new_tokens=4) for i in range(3)]
    eng = ContinuousBatchingEngine(tcfg, tparams, debug_checks=True, lanes=2, n_pages=5,
                                   page_tokens=4, lane_capacity=12, device="cpu")
    rep = ContinuousScheduler(eng).run(reqs)
    assert len(rep.completed) == 3 and rep.page_deferrals > 0
    assert eng.alloc.used_pages == 0
    big = [Request(rid="big", prompt=np.zeros(7, np.int32), max_new_tokens=8)]
    with pytest.raises(ValueError, match="lanes hold"):
        ContinuousScheduler(eng).run(big)


@pytest.mark.parametrize("continuous", [False, True])
def test_launch_serve_runs_on_cpu(continuous, capsys):
    from repro_torch.launch import serve

    argv = ["--arch", "llama3-8b", "--device", "cpu", "--requests", "3"]
    serve.main(argv + (["--continuous"] if continuous else []))
    out = capsys.readouterr().out
    assert ("served 3 requests" if continuous else "generated (4, 16)") in out


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_continuous_engine_refuses_families_without_a_kv_cache(arch):
    """Both engines raise the same ValueError for the recurrent families."""
    cfg = small_config(arch)
    with pytest.raises(ValueError, match="paged serving needs a KV-cache family") as want:
        RefContinuous(cfg, {}, lanes=1, n_pages=4)
    with pytest.raises(ValueError, match="paged serving needs a KV-cache family") as got:
        ContinuousBatchingEngine(port_config(cfg), {}, lanes=1, n_pages=4, device="cpu")
    assert str(got.value) == str(want.value)


SERVED = ["rwkv6-1.6b", "zamba2-2.7b", "qwen3-moe-30b-a3b", "grok-1-314b"]


@pytest.mark.parametrize("arch", SERVED)
def test_serving_engine_greedy_tokens_match_reference(arch):
    """``ServingEngine.generate`` against the reference's on the same
    prompts and bridged weights (fp32): the recurrent families feed the
    prompt through ``decode_step`` token by token, the MoE ones run their
    fused prefill, as in the reference."""
    cfg = small_config(arch)
    jparams, tparams = bridged(cfg)
    prompts = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 7), dtype=np.int32)
    want = RefServing(cfg, jparams, batch=2, capacity=16).generate(prompts, 5)
    eng = ServingEngine(port_config(cfg), tparams, batch=2, capacity=16, device="cpu")
    got = eng.generate(prompts, 5)
    np.testing.assert_array_equal(got, want)
    assert eng.stats.prefills == 1 and eng.stats.decode_steps == 4
    assert (eng.api.prefill is None) == (arch in ("rwkv6-1.6b", "zamba2-2.7b"))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b"])
def test_continuous_greedy_tokens_match_reference_engine_moe(arch, monkeypatch):
    """The MoE family through both continuous engines over the smoke trace.
    An expert's capacity depends on the tokens of the call, so a decode
    tick's tokens depend on which lanes are live: both schedulers run on
    the same fixed-step clock (each engine operation lasts 1 ms), so both
    engines see the same lanes at every tick."""
    import itertools
    import types

    from repro.serve import scheduler as ref_sched_mod
    from repro_torch.serve import scheduler as sched_mod

    for mod in (ref_sched_mod, sched_mod):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=itertools.count(0.0, 1e-3).__next__))
    cfg = small_config(arch)
    jparams, tparams = bridged(cfg)
    kw = dict(lanes=4, n_pages=25, page_tokens=4, lane_capacity=24)
    want = RefScheduler(RefContinuous(cfg, jparams, **kw)).run(ref_load_requests(SMOKE_TRACE))
    eng = ContinuousBatchingEngine(port_config(cfg), tparams, debug_checks=True,
                                   device="cpu", **kw)
    got = ContinuousScheduler(eng).run(load_requests(SMOKE_TRACE))
    assert len(got.completed) == 24 and eng.alloc.used_pages == 0
    assert _by_rid(got) == _by_rid(want)


@pytest.mark.parametrize("arch", SERVED)
def test_launch_serve_runs_every_family_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--device", "cpu", "--new-tokens", "4"])
    assert "generated (4, 4) tokens on cpu" in capsys.readouterr().out
