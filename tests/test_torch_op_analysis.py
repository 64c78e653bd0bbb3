"""``repro_torch.launch.op_analysis`` (the counterpart of
``repro/launch/hlo_analysis.py``) and the kernels' registered operators:
exact FLOPs of the products autograd runs, no collectives on one device,
bytes written without views, the peak of live storages, and each kernel
operator's fake implementation (shapes) and FLOP formula (the counts of
``PERF.md``'s bound column), and the collectives' operand bytes on a fake
process group.  The collective bytes over a fake process group against
real gloo ranks and against the analytic count are in
``tests/test_torch_distributed.py`` (they share its spawned ranks)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels import wkv6 as wk
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.op_analysis import BLOCK, MIB, _LargePool, analyze_step


def _grad_of_tanh_stack(x, ws):
    h = x
    for w in ws:
        h = torch.tanh(h @ w)
    return torch.autograd.grad(h.sum(), ws)


def test_scan_like_stack_counts_exact_product_flops():
    """The L-layer ``tanh(h @ w)`` gradient of ``tests/test_hlo_analysis.py``:
    eager execution dispatches every layer, so the count is exact (no trip
    multiplier): ``2 B D D`` per forward product and per backward product,
    two of those a layer, less the first layer's input gradient, which
    autograd skips since ``x`` needs none."""
    L, B, D = 6, 4, 32
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, D), dtype=np.float32))
    ws = [torch.from_numpy(rng.standard_normal((D, D), dtype=np.float32) * 0.1)
          .requires_grad_() for _ in range(L)]
    costs = analyze_step(_grad_of_tanh_stack, x, ws)
    per = 2 * B * D * D
    assert costs.flops == L * per + L * per + (L - 1) * per
    assert costs.flops_by_op == {"aten.mm": costs.flops}
    assert len(costs.out) == L and all(g.shape == (D, D) for g in costs.out)


def test_no_collectives_single_device():
    costs = analyze_step(lambda a: (a @ a).sum(), torch.ones(16, 16))
    assert costs.collectives == {} and costs.collective_bytes == 0
    assert costs.flops == 2 * 16 ** 3
    assert "n_collective_ops" not in costs.diag


def test_fake_group_counts_known_collective_operand_bytes():
    """On rank 0 of a fake group of 4, one call of each collective on
    tensors of known sizes counts each kind's operand bytes, as on the gloo
    ranks of ``tests/test_torch_distributed.py``
    (``_dist_ranks.primitive_collectives``)."""
    import _dist_ranks

    with fake_world(4, "meta"):
        fn, args, expected = _dist_ranks.primitive_collectives(4)
        costs = analyze_step(fn, *args)
    assert costs.collectives == expected
    assert costs.diag["n_collective_ops"] == 9


def test_bytes_written_skip_views_and_peak_counts_live_blocks():
    """A view writes nothing and shares its base's storage; the peak is the
    largest sum of live storages, each rounded to a 512-byte block, the
    arguments' included."""
    def f(a):
        b = a * 2.0             # 4000 bytes -> 4096 live
        c = b.view(10, 100)     # a view: no bytes, no new storage
        d = c + 1.0             # 4000 more: a, b, d live, the peak
        del b, c
        return d.sum()          # 4 bytes -> 512, with b gone

    a = torch.ones(1000, device="meta")
    costs = analyze_step(f, a)
    assert costs.bytes_written == 4000 + 4000 + 4
    assert costs.peak_bytes == 3 * 4096 > 2 * 4096 + BLOCK


def test_in_place_writes_count():
    def f(a):
        a.mul_(2.0)
        return a
    costs = analyze_step(f, torch.ones(256, device="meta"))
    assert costs.bytes_written == 1024


@pytest.mark.parametrize("fake", [False, True])
@pytest.mark.parametrize("op", ["_wrap_tensor_autograd", "wait_tensor"])
def test_collective_wrapper_is_its_inputs_memory(op, fake):
    """The functional collectives' ``_wrap_tensor_autograd`` (an
    ``AsyncCollectiveTensor`` around its input on real tensors) and
    ``wait_tensor`` (its input itself), which DTensor's redistribution
    calls on every collective's result, return fresh tensors on fake ones:
    either way no new memory and nothing written.  Views of the result
    count as the input, which lives while they do.  The peak is a, its
    product, the reordered copy and that plus one (4096 each) and a sum
    (512): no second copy of the product."""
    import torch.distributed._functional_collectives  # noqa: F401  (registers the operators)
    from torch._subclasses.fake_tensor import FakeTensorMode

    fn = getattr(torch.ops._c10d_functional, op).default

    def f(a):
        x = a * 2.0
        y = torch.cat(torch.split(fn(x), 500)[::-1])
        return (y + 1.0).sum() + x.sum()

    with FakeTensorMode() if fake else torch.no_grad():
        a = torch.ones(1000, device="meta")
        costs = analyze_step(f, a)
    assert costs.peak_bytes == 4 * 4096 + BLOCK
    assert costs.bytes_written == 3 * 4000 + 3 * 4


def _meta(shape, dtype=torch.bfloat16, grad=True):
    return torch.empty(shape, dtype=dtype, device="meta").requires_grad_(grad)


@pytest.mark.parametrize("causal,window,Sq,Skv", [(True, 0, 130, 130), (True, 48, 96, 96),
                                                  (False, 0, 32, 160)])
def test_flash_operators_fake_shapes_and_formulas(causal, window, Sq, Skv):
    B, H, KV, d = 2, 6, 2, 64
    q, k, v = _meta((B, Sq, H, d)), _meta((B, Skv, KV, d)), _meta((B, Skv, KV, d))
    before = dict(fa.launches)

    def step(q, k, v):
        o = fa.flash_attention(q, k, v, causal=causal, window=window)
        return o, torch.autograd.grad(o.float().sum(), (q, k, v))

    costs = analyze_step(step, q, k, v)
    o, grads = costs.out
    assert o.shape == q.shape and [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    pairs = sum(len([j for j in range(Skv) if (not causal or j <= i)
                     and (window == 0 or j > i - window)]) for i in range(Sq))
    assert fa.attention_pairs(Sq, Skv, causal, window) == pairs
    assert costs.flops_by_op["repro_torch.flash_attention_fwd"] == 4 * B * H * d * pairs
    assert costs.flops_by_op["repro_torch.flash_attention_bwd"] == 10 * B * H * d * pairs
    assert fa.launches == before  # a fake implementation launches nothing
    with torch.no_grad():
        assert fa.flash_attention(q, k, v, causal=causal).shape == q.shape


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "ssd_chunk"), (torch.float32, "ssd")])
def test_ssd_operators_fake_shapes_and_formulas(dtype, route):
    B, S, H, P, N = 2, 130, 4, 32, 16
    x, Bm, Cm = _meta((B, S, H, P), dtype), _meta((B, S, N), dtype), _meta((B, S, N), dtype)
    dt, A = _meta((B, S, H), torch.float32), _meta((H,), torch.float32)
    s0 = _meta((B, H, P, N), torch.float32)
    ins = (x, dt, A, Bm, Cm, s0)

    def step(*ins):
        y, sT = ss.ssd(*ins)
        return y, sT, torch.autograd.grad((y.float().sum(), sT.sum()), ins)

    before = dict(ss.launches)
    y, sT, grads = (costs := analyze_step(step, *ins)).out
    assert y.shape == x.shape and sT.shape == (B, H, P, N)
    assert [g.shape for g in grads] == [t.shape for t in ins]
    count = ss.chunk_flops if route == "ssd_chunk" else ss.recurrence_flops
    assert costs.flops_by_op[f"repro_torch.{route}_fwd"] == count(B, S, H, P, N)
    assert costs.flops_by_op[f"repro_torch.{route}_bwd"] == count(B, S, H, P, N, backward=True)
    assert ss.launches == before


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wkv6_chunk"), (torch.float32, "wkv6")])
def test_wkv6_operators_fake_shapes_and_formulas(dtype, route):
    B, S, H, N = 2, 70, 3, 32
    r, k, v, w = (_meta((B, S, H, N), dtype) for _ in range(4))
    u, s0 = _meta((H, N), torch.float32), _meta((B, H, N, N), torch.float32)
    ins = (r, k, v, w, u, s0)

    def step(*ins):
        o, sT = wk.wkv6(*ins)
        return o, sT, torch.autograd.grad((o.float().sum(), sT.sum()), ins)

    before = dict(wk.launches)
    o, sT, grads = (costs := analyze_step(step, *ins)).out
    assert o.shape == v.shape and sT.shape == (B, H, N, N)
    assert [(g.shape, g.dtype) for g in grads] == [(t.shape, t.dtype) for t in ins]
    count = wk.chunk_flops if route == "wkv6_chunk" else wk.recurrence_flops
    assert costs.flops_by_op[f"repro_torch.{route}_fwd"] == count(B, S, H, N)
    assert costs.flops_by_op[f"repro_torch.{route}_bwd"] == count(B, S, H, N, backward=True)
    assert wk.launches == before


def test_formulas_are_the_bound_columns_counts():
    """At the shapes ``PERF.md`` section 6 bounds (qwen2: 4 x 4096, 12 heads
    of 128, causal; SSD 4 x 4096, H=80, P=N=64; WKV-6 4 x 4096, H=32,
    K=V=64) the formulas give that column's GFLOP."""
    assert round(fa.flops_fwd(4, 4096, 4096, 12, 128, True, 0) / 1e9, 2) == 206.21
    assert round(fa.flops_bwd(4, 4096, 4096, 12, 128, True, 0) / 1e9, 2) == 515.52
    assert round(fa.flops_fwd(4, 4096, 4096, 32, 80, True, 4096) / 1e9, 2) == 343.68
    assert round(ss.chunk_flops(4, 4096, 80, 64, 64) / 1e9, 2) == 64.42
    assert round(ss.chunk_flops(4, 4096, 80, 64, 64, backward=True) / 1e9, 2) == 128.85
    assert round(wk.chunk_flops(4, 4096, 32, 64) / 1e9, 2) == 12.88
    assert round(wk.chunk_flops(4, 4096, 32, 64, backward=True) / 1e9, 2) == 25.77
    assert round(wk.recurrence_flops(4, 4096, 32, 64) / 1e9, 2) == 10.87
    assert round(wk.recurrence_flops(4, 4096, 32, 64, backward=True) / 1e9, 2) == 30.06


def test_large_blocks_take_the_allocators_blocks():
    """Over 1 MiB a block is the caching allocator's: a new segment (20 MiB
    below 10 MiB, else rounded up to 2 MiB), held whole where splitting it
    would leave 1 MiB or less (the vocab-parallel loss's (16, 1024, 16016)
    fp32 tensors, 1001 MiB, hold 1002), else split; a freed block is taken
    again by the smallest request it fits, split where it leaves more than
    1 MiB, and merges with its free neighbours.  A step's new meta tensors
    count so, its arguments at their sizes (made before the step)."""
    pool = _LargePool()
    assert pool.malloc(1001 * MIB) == (0, 0, 1002 * MIB)
    assert pool.malloc(3 * MIB) == (1, 0, 3 * MIB)  # a 20 MiB segment, split
    a = pool.malloc(10 * MIB + MIB // 2)  # from its free 17 MiB, split
    assert a == (1, 3 * MIB, 10 * MIB + MIB // 2)
    assert pool.malloc(16 * MIB) == (2, 0, 16 * MIB)  # 6.5 MiB free: a new segment
    pool.release(*a[:2])  # merges with the free 6.5 MiB after it: 17 MiB
    assert pool.malloc(16 * MIB + MIB // 2) == (1, 3 * MIB, 17 * MIB)  # held whole
    big = torch.empty((16, 1024, 16016), dtype=torch.float32, device="meta")
    costs = analyze_step(lambda x: x * 2.0, big)
    assert costs.peak_bytes == 1001 * MIB + 1002 * MIB
