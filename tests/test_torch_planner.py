"""The port's planner stack against the reference's, on the CPU.

Graph builders, burst plans (``plan``, ``plan_data_parallel``,
``plan_encdec``), the static verifier and ``calibrate_kinds``.  The
planner is numpy in both packages, so the oracle is equality, not a
tolerance: per-layer scales and times, totals, amplification, block
placements and ``summary()`` agree bit for bit.  Every case runs under
the reference's ``A100`` and TPU fields and the port's ``H100`` fields,
each passed to both packages.  The seeded differential suite of
``tests/test_planner_diff.py`` runs against the port's ``search_linear``
and ``search_linear_reference`` through the same shim.
"""
import dataclasses
import random

import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # tier-1 must collect without hypothesis
    from _prop import given, settings, strategies as st

from repro.configs import TRAIN_4K as REF_TRAIN_4K
from repro.configs import get_config as ref_get_config
from repro.configs.vgg16 import CONFIG as REF_VGG
from repro.core import costmodel as ref_costmodel
from repro.core import planner as ref_planner
from repro.models import graph as ref_graph
from repro_torch.analysis.verify import verify_carving, verify_plan
from repro_torch.configs import TRAIN_4K, get_config
from repro_torch.configs.vgg16 import CONFIG as VGG
from repro_torch.core import costmodel, planner
from repro_torch.core.profiler import calibrate_kinds, profile_graph, powers_of_two
from repro_torch.models import graph
from repro_torch.models.api import get_model, train_input_specs
from test_planner_diff import _rand_block, _rand_graph, _rand_hw, _rand_node

LM_ARCHS = ["llama3-8b", "qwen2-1.5b", "minicpm-2b", "rwkv6-1.6b", "zamba2-2.7b"]
DEVICES = [8, 64, 256]
AMP_LIMIT = 2.0


def plain(x):
    """Dataclasses of either package as (class name, fields), recursively,
    so the two packages' records compare with ``==`` (floats exactly)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


def to_port(el):
    """A reference graph element (node, block, enc-dec graph) as the port's."""
    if isinstance(el, ref_graph.LayerNode):
        return graph.LayerNode(**dataclasses.asdict(el))
    if isinstance(el, ref_graph.ParallelBlock):
        return graph.ParallelBlock(el.name, tuple(tuple(to_port(x) for x in br)
                                                  for br in el.branches))
    if isinstance(el, ref_graph.EncDecGraph):
        return graph.EncDecGraph(el.name, tuple(map(to_port, el.encoder)),
                                 tuple(map(to_port, el.decoder)), el.cross_act_bytes)
    return [to_port(x) for x in el]


HARDWARE = {  # name -> the same fields for both packages
    "a100": dataclasses.asdict(ref_costmodel.A100),
    "tpu-v5e": dataclasses.asdict(ref_costmodel.V5E),
    "h100": dataclasses.asdict(costmodel.H100),
}


def _hw(name):
    f = HARDWARE[name]
    return ref_costmodel.Hardware(**f), costmodel.Hardware(**f)


def _encdec_shape(pkg_train_4k):
    return dataclasses.replace(pkg_train_4k, seq_len=256, global_batch=8, name="encdec-reg")


GRAPHS = {  # name -> (reference graph, port graph), each from its own package
    **{a: (lambda a=a: (ref_graph.build_lm_graph(ref_get_config(a), REF_TRAIN_4K),
                        graph.build_lm_graph(get_config(a), TRAIN_4K))) for a in LM_ARCHS},
    "vgg16": lambda: (ref_graph.build_vgg_graph(REF_VGG, 32), graph.build_vgg_graph(VGG, 32)),
    "inception": lambda: (ref_graph.build_inception_like_graph(32, n_blocks=3),
                          graph.build_inception_like_graph(32, n_blocks=3)),
    "seamless-encdec": lambda: (
        ref_graph.build_encdec_graph(ref_get_config("seamless-m4t-large-v2").reduced(),
                                     _encdec_shape(REF_TRAIN_4K)),
        graph.build_encdec_graph(get_config("seamless-m4t-large-v2").reduced(),
                                 _encdec_shape(TRAIN_4K))),
}


def test_configs_field_for_field():
    for a in LM_ARCHS + ["seamless-m4t-large-v2"]:
        assert dataclasses.asdict(get_config(a)) == dataclasses.asdict(ref_get_config(a)), a


@pytest.mark.parametrize("name", sorted(GRAPHS) + ["wrn"])
def test_graph_builders_give_equal_nodes(name):
    if name == "wrn":
        ref, port = ref_graph.build_wrn_graph(16), graph.build_wrn_graph(16)
    else:
        ref, port = GRAPHS[name]()
    assert plain(port) == plain(ref)
    if not isinstance(ref, ref_graph.EncDecGraph):
        assert graph.total_fwd_flops(port) == ref_graph.total_fwd_flops(ref)
        assert plain(graph.flatten_nodes(port)) == plain(ref_graph.flatten_nodes(ref))


def _same_plan(port, ref):
    assert [l.gpus for l in port.layers] == [l.gpus for l in ref.layers]
    assert [l.time for l in port.layers] == [l.time for l in ref.layers]
    assert port.total_time == ref.total_time
    assert port.amplification == ref.amplification
    assert plain(port) == plain(ref)  # every layer field, block placements
    assert port.summary() == ref.summary()
    assert plain(port.stages()) == plain(ref.stages())
    assert plain(port.gaps()) == plain(ref.gaps())


@pytest.mark.parametrize("hw", sorted(HARDWARE))
@pytest.mark.parametrize("G", DEVICES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plans_bit_identical(name, G, hw):
    ref_g, port_g = GRAPHS[name]()
    ref_hw, port_hw = _hw(hw)
    ref = ref_planner.plan(ref_g, G, amp_limit=AMP_LIMIT, hw=ref_hw)
    port = planner.plan(port_g, G, amp_limit=AMP_LIMIT, hw=port_hw)
    _same_plan(port, ref)
    assert verify_plan(port, pool_size=G) == []
    if isinstance(port_g, graph.EncDecGraph):
        _same_plan(planner.plan_encdec(port_g, G, AMP_LIMIT, port_hw),
                   ref_planner.plan_encdec(ref_g, G, AMP_LIMIT, ref_hw))
        return
    _same_plan(planner.plan_data_parallel(port_g, G, hw=port_hw),
               ref_planner.plan_data_parallel(ref_g, G, hw=ref_hw))
    # the golden invariants of tests/test_plan_regression.py
    free = planner.plan(port_g, G, amp_limit=1e9, hw=port_hw)
    dp = planner.plan_data_parallel(port_g, G, hw=port_hw)
    assert free.total_time <= dp.total_time * (1 + 1e-9)
    assert port.amplification <= AMP_LIMIT + 1e-9


@pytest.mark.parametrize("G", [7, 48, 1021])  # survivor pools: non-pow2 scale sets
def test_non_pow2_pools_and_reference_engine(G):
    ref_g, port_g = GRAPHS["llama3-8b"]()
    ref_hw, port_hw = _hw("h100")
    for engine in ("vectorized", "reference"):
        _same_plan(planner.plan(port_g, G, AMP_LIMIT, port_hw, engine=engine),
                   ref_planner.plan(ref_g, G, AMP_LIMIT, ref_hw, engine=engine))
    for name in ("inception", "seamless-encdec"):  # blocks and the enc-dec join
        ref_g, port_g = GRAPHS[name]()
        _same_plan(planner.plan(port_g, G, AMP_LIMIT, port_hw, engine="reference"),
                   ref_planner.plan(ref_g, G, AMP_LIMIT, ref_hw, engine="reference"))


def test_default_hardware_is_h100():
    assert costmodel.Hardware() == costmodel.H100
    assert costmodel.H100.name == "h100-sxm5"
    assert not hasattr(costmodel, "V5E")  # the TPU constants stay in the reference
    assert dataclasses.asdict(costmodel.A100) == dataclasses.asdict(ref_costmodel.A100)
    g = graph.build_lm_graph(get_config("qwen2-1.5b"), TRAIN_4K)
    assert plain(planner.plan(g, 64)) == plain(planner.plan(g, 64, hw=costmodel.H100))


# -- the seeded differential suite (tests/test_planner_diff.py), on the port --


def _port_hw(ref_hw):
    return costmodel.Hardware(**dataclasses.asdict(ref_hw))


def _engines_agree(bv, br, seed):
    """The two engines' plans, compared as tests/test_planner_diff.py does
    (the reference engine records no block placements)."""
    assert [l.gpus for l in bv.layers] == [l.gpus for l in br.layers], seed
    assert bv.total_time == br.total_time, seed  # bit for bit, no tolerance
    for a, b in zip(bv.layers, br.layers):
        assert a.time == b.time and a.comm_in == b.comm_in and a.amp == b.amp, (seed, a.name)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 10**9), st.sampled_from([2, 8, 64, 256]))
def test_differential_random_graphs(seed, G):
    """The port's vectorized plan == its reference engine == the JAX
    package's plan, on random chain + nested-block graphs."""
    rnd = random.Random(seed)
    g = _rand_graph(rnd)
    hw = _rand_hw(rnd)
    amp_limit = rnd.choice([1.2, 2.0, 4.0, 1e9])
    pg, phw = to_port(g), _port_hw(hw)
    bv = planner.plan(pg, G, amp_limit=amp_limit, hw=phw, engine="vectorized")
    br = planner.plan(pg, G, amp_limit=amp_limit, hw=phw, engine="reference")
    _engines_agree(bv, br, seed)
    assert plain(bv) == plain(ref_planner.plan(g, G, amp_limit=amp_limit, hw=hw)), seed


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10**9))
def test_differential_search_tables(seed):
    """The port's raw DP tables agree cell for cell with its oracle,
    including entry pinning."""
    rnd = random.Random(seed)
    nodes = [_rand_node(rnd, f"n{i}") for i in range(rnd.randint(1, 6))]
    hw = _port_hw(_rand_hw(rnd))
    G = rnd.choice([8, 64])
    scales = powers_of_two(G)
    chain = profile_graph(to_port(nodes), G, hw)
    entry = rnd.choice([None, rnd.choice(scales)])
    eb = rnd.uniform(1e3, 1e9) if entry is not None else 0.0
    vec = planner.search_linear(chain, scales, 2.0, hw, entry_scale=entry, entry_act_bytes=eb)
    ref = planner.search_linear_reference(chain, scales, 2.0, hw, entry_scale=entry,
                                          entry_act_bytes=eb)
    for i in range(len(ref.layers)):
        for gi, g in enumerate(scales):
            assert vec.S[0, i, gi] == ref.S[i][g], (seed, i, g)
            assert vec.T[0, i, gi] == ref.T[i][g], (seed, i, g)
            p = ref.P[i][g]
            if i == 0:
                assert p == (g if entry is None else entry), (seed, i, g)
                vp = vec.P[0, i, gi]
                assert (vp == -1) if entry is None else (scales[vp] == entry)
            else:
                assert scales[vec.P[0, i, gi]] == p, (seed, i, g)


def test_differential_block_matrix_vs_table():
    from repro_torch.core.graph_reduce import block_transition_matrix, block_transition_table

    rnd = random.Random(12345)
    block = to_port(_rand_block(rnd, "blk", depth=1))
    scales = powers_of_two(64)
    chain = profile_graph([block, to_port(_rand_node(rnd, "tail"))], 64, costmodel.A100)
    bm = block_transition_matrix(chain[0], scales, 2.0, costmodel.A100, 1e6)
    table = block_transition_table(chain[0], scales, 2.0, costmodel.A100, 1e6)
    for gi, g in enumerate(scales):
        for hi, h in enumerate(scales):
            t, gs = table[(g, h)]
            assert bm.time[gi, hi] == t and bm.gpu_sec[gi, hi] == gs, (g, h)


def test_differential_fixed_seeds_repro():
    for seed in (0, 1, 7, 42, 1337, 99991):
        rnd = random.Random(seed)
        g = _rand_graph(rnd)
        hw = _port_hw(_rand_hw(rnd))
        bv = planner.plan(to_port(g), 64, amp_limit=2.0, hw=hw)
        br = planner.plan(to_port(g), 64, amp_limit=2.0, hw=hw, engine="reference")
        _engines_agree(bv, br, seed)


# -- model API, calibration ---------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-1.5b", "rwkv6-1.6b", "zamba2-2.7b"])
def test_api_layer_graph_and_input_specs(arch):
    from repro.models import get_model as ref_get_model
    from repro.models.api import train_input_specs as ref_specs

    shape = dataclasses.replace(TRAIN_4K, seq_len=512, global_batch=4)
    ref_shape = dataclasses.replace(REF_TRAIN_4K, seq_len=512, global_batch=4)
    api = get_model(get_config(arch))
    assert plain(api.layer_graph(shape)) == plain(
        ref_get_model(ref_get_config(arch)).layer_graph(ref_shape))
    specs, want = train_input_specs(api.cfg, shape), ref_specs(ref_get_config(arch), ref_shape)
    assert sorted(specs) == sorted(want)
    for k, t in specs.items():
        assert t.device.type == "meta" and tuple(t.shape) == want[k].shape
        assert t.dtype == torch.long  # the port's batches are int64


def test_input_specs_refuse_unported_batches():
    with pytest.raises(NotImplementedError, match="item 10"):
        train_input_specs(get_config("seamless-m4t-large-v2"), TRAIN_4K)


def test_calibrate_kinds_one_ratio_per_kind():
    for g in (graph.build_lm_graph(get_config("llama3-8b").reduced(), TRAIN_4K),
              graph.build_vgg_graph(VGG, 8)):
        kinds = {n.kind for n in g if isinstance(n, graph.LayerNode)}
        ratios = calibrate_kinds(g, repeats=2, device="cpu")
        assert set(ratios) == kinds
        assert min(ratios.values()) == 1.0 and all(r >= 1.0 for r in ratios.values())


def test_calibration_needs_a_card_unless_told_cpu(monkeypatch):
    from repro_torch.core.profiler import measure_kernel_overhead

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = graph.build_vgg_graph(VGG, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate_kinds(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure_kernel_overhead()
    with pytest.raises(ValueError, match="CUDA card"):
        measure_kernel_overhead("cpu")


def test_plan_verifier_clean_and_carving():
    _, port_g = GRAPHS["inception"]()
    bp = planner.plan(port_g, 8, amp_limit=AMP_LIMIT, hw=costmodel.A100)
    assert verify_plan(bp, pool_size=8) == []
    assert verify_carving(bp, tenants=2) == []
