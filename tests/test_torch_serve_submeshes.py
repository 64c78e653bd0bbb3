"""Prefill/decode disaggregation (``ContinuousBatchingEngine(submeshes=)``)
against the reference's, on the CPU.

The reference carves ``split_mesh_for_serving(1, ...)`` over its one CPU
device listed twice; the port over two positions of ``torch.device("cpu")``
(the same-device mode: on a card both slices are that card, each on a
stream of its own).  Greedy tokens over the smoke trace must equal the
reference's disaggregated engine and the port's own single-slice engine;
every admit records one handoff; no page leaks.
"""
import os

import jax
import pytest
import torch

from repro.launch.mesh import split_mesh_for_serving as ref_split
from repro.serve.engine import ContinuousBatchingEngine as RefContinuous
from repro.serve.scheduler import ContinuousScheduler as RefScheduler
from repro.serve.trace import load_requests as ref_load_requests
from repro_torch.launch.mesh import split_mesh_for_serving
from repro_torch.serve.engine import ContinuousBatchingEngine
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.serve.trace import load_requests
from test_torch_bridge import bridged, port_config, small_config

SMOKE_TRACE = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "traces",
                           "requests_smoke.json")
KW = dict(lanes=4, n_pages=25, page_tokens=4, lane_capacity=24)


@pytest.fixture(scope="module")
def llama():
    cfg = small_config("llama3-8b")
    jparams, tparams = bridged(cfg)
    return cfg, port_config(cfg), jparams, tparams


def _by_rid(report):
    return {r.rid: tuple(r.tokens) for r in report.completed}


def test_disaggregated_tokens_match_reference_and_single_slice(llama):
    cfg, tcfg, jparams, tparams = llama
    want = RefScheduler(RefContinuous(cfg, jparams, submeshes=ref_split(
        1, devices=jax.devices()[:1] * 2), **KW)).run(ref_load_requests(SMOKE_TRACE))
    sm = split_mesh_for_serving(1, devices=[torch.device("cpu")] * 2)
    assert sm.prefill_range == (0, 1) and sm.decode_range == (1, 2) and sm.disjoint()
    eng = ContinuousBatchingEngine(tcfg, tparams, submeshes=sm, debug_checks=True, **KW)
    got = ContinuousScheduler(eng).run(load_requests(SMOKE_TRACE))
    alone = ContinuousScheduler(ContinuousBatchingEngine(tcfg, tparams, device="cpu", **KW)
                                ).run(load_requests(SMOKE_TRACE))
    assert len(got.completed) == 24
    assert _by_rid(got) == _by_rid(want) == _by_rid(alone)
    assert len(eng.handoff_s) == eng.stats.prefills == 24
    assert eng.alloc.used_pages == 0
    assert eng.params_prefill is eng.params  # one copy on one device
    eng.reset()
    assert eng.handoff_s == [] and eng.alloc.used_pages == 0


def test_submeshes_fix_the_device(llama):
    _, tcfg, _, tparams = llama
    sm = split_mesh_for_serving(1, devices=[torch.device("cpu")] * 2)
    eng = ContinuousBatchingEngine(tcfg, tparams, submeshes=sm, **KW)
    assert eng.device == eng.prefill_device == torch.device("cpu")
    assert eng.prefill_stream is None and eng.decode_stream is None
    with pytest.raises(ValueError, match="decode slice"):
        ContinuousBatchingEngine(tcfg, tparams, submeshes=sm, device="meta", **KW)
