"""The port's WKV-6 (``repro_torch.kernels.wkv6``) against the reference.

On the CPU the wrapper takes ``wkv6_plain``, the kernel's plain version;
it is held against the reference's chunked form ``wkv6_chunked``, its
sequential oracle ``wkv6_reference`` and its Pallas kernel in interpret
mode, and its gradients against ``jax.grad`` of the sequential oracle.
Tolerances: 5e-4 forward (as ``tests/test_kernels.py``), 1e-3 on
gradients, absolute and relative, all in fp32.

Decays are ``w = exp(-exp(dec))``.  The reference's chunked forms
(``wkv6_chunked`` and the Pallas kernel) form ``k * exp(-cumsum(log w))``
and break once decays are strong: measured on the CPU at chunk 64 they
are off by 0.33 at dec = 0.3 and NaN from dec = 0.5 on.  There the port is
held against ``wkv6_reference`` alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.models.rwkv6 import wkv6_chunked as ref_wkv6_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wkv6 as wk

FWD_TOL = 5e-4
GRAD_TOL = 1e-3


def _inputs(B, S, H, K, V, *, dec=None, seed=0, init=False):
    """numpy r, k, v, w, u (and init state): the reference sweep's draw
    (w in (0.45, 0.95)) when ``dec`` is None, else w = exp(-exp(dec + noise))."""
    rng = np.random.default_rng(seed)
    r, k = (0.5 * rng.standard_normal((B, S, H, K)) for _ in range(2))
    v = 0.5 * rng.standard_normal((B, S, H, V))
    if dec is None:
        w = 0.45 + 0.5 / (1 + np.exp(-rng.standard_normal((B, S, H, K))))
    else:
        w = np.exp(-np.exp(dec + 0.1 * rng.standard_normal((B, S, H, K))))
    u = 0.3 * rng.standard_normal((H, K))
    out = [x.astype(np.float32) for x in (r, k, v, w, u)]
    if init:
        out.append((0.5 * rng.standard_normal((B, H, K, V))).astype(np.float32))
    return out


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("S,K", [(64, 32), (128, 64), (192, 32)])
def test_plain_matches_reference_forms(S, K):
    arrs = _inputs(2, S, 3, K, K, seed=S + K)
    o, state = wk.wkv6_plain(*_t(arrs))
    want_seq = jref.wkv6_reference(*_j(arrs))
    want_chunk, want_state = ref_wkv6_chunked(*_j(arrs), chunk=64)
    want_pallas = ref_ops.wkv(*_j(arrs), chunk=64, force="pallas_interpret")
    for want in (want_seq, want_chunk, want_pallas):
        _close(o, want, FWD_TOL)
    _close(state, want_state, FWD_TOL)


@pytest.mark.parametrize("S", [1, 17, 100])
def test_plain_any_length(S):
    """Ragged S (the reference's chunked forms need multiples of the chunk)."""
    arrs = _inputs(1, S, 2, 32, 32, seed=S)
    o, _ = wk.wkv6_plain(*_t(arrs))
    _close(o, jref.wkv6_reference(*_j(arrs)), FWD_TOL)


@pytest.mark.parametrize("dec", [0.5, 1.0, 2.0])
def test_strong_decays_stay_finite_and_exact(dec):
    """w = 0.19, 0.066, 6.2e-4: the reference's chunked form is NaN at all
    three (see the module docstring); the port matches the sequential
    oracle."""
    arrs = _inputs(1, 128, 2, 64, 64, dec=dec, seed=3)
    o, state = wk.wkv6_plain(*_t(arrs))
    assert torch.isfinite(o).all() and torch.isfinite(state).all()
    _close(o, jref.wkv6_reference(*_j(arrs)), FWD_TOL)
    _, want_state = tref.wkv6_reference(*_t(arrs))
    _close(state, want_state.numpy(), FWD_TOL)


def test_port_oracle_matches_reference_oracle():
    arrs = _inputs(2, 40, 2, 32, 32, dec=0.0, seed=4)
    o, _ = tref.wkv6_reference(*_t(arrs))
    _close(o, jref.wkv6_reference(*_j(arrs)), 1e-5)


@pytest.mark.parametrize("split", [37, 64])
def test_state_handoff(split):
    """Two halves with the state carried between them equal the whole
    sequence; the final state matches the reference's."""
    r, k, v, w, u, s0 = _t(_inputs(2, 100, 3, 32, 32, seed=split, init=True))
    o, state = wk.wkv6(r, k, v, w, u, s0)
    o1, s1 = wk.wkv6(r[:, :split], k[:, :split], v[:, :split], w[:, :split], u, s0)
    o2, s2 = wk.wkv6(r[:, split:], k[:, split:], v[:, split:], w[:, split:], u, s1)
    _close(torch.cat([o1, o2], 1), o.numpy(), FWD_TOL)
    _close(s2, state.numpy(), FWD_TOL)
    want_o, want_state = tref.wkv6_reference(r, k, v, w, u, s0)
    _close(o, want_o.numpy(), FWD_TOL)
    _close(state, want_state.numpy(), FWD_TOL)
    # the reference's chunked form carries the state the same way
    arrs = [x.numpy() for x in (r, k, v, w, u)]
    jo, jstate = ref_wkv6_chunked(*_j([a[:, :64] if a.ndim == 4 else a for a in arrs]),
                                  chunk=64, init_state=jnp.asarray(s0.numpy()))
    o64, s64 = wk.wkv6(r[:, :64], k[:, :64], v[:, :64], w[:, :64], u, s0)
    _close(o64, jo, FWD_TOL)
    _close(s64, jstate, FWD_TOL)


def _jax_wkv_with_state(r, k, v, w, u, s0):
    """``wkv6_reference``'s recurrence with an initial state and the final
    state returned (the reference oracle has neither)."""
    def step(s, inp):
        r_t, k_t, v_t, w_t = inp
        kv = jnp.einsum("bhk,bhv->bhkv", k_t, v_t)
        o = jnp.einsum("bhk,bhkv->bhv", r_t, s + u[None, :, :, None] * kv)
        return s * w_t[..., None] + kv, o

    sT, os = jax.lax.scan(step, s0, tuple(jnp.moveaxis(a, 1, 0) for a in (r, k, v, w)))
    return jnp.moveaxis(os, 0, 1), sT


@pytest.mark.parametrize("dec", [-1.0, 1.0, 2.0])
def test_gradients_match_jax_grad(dec):
    """d/d(r, k, v, w, u) of <o, P> for a fixed random P, against jax.grad
    of the sequential oracle; moderate (w 0.69) and strong decays."""
    arrs = _inputs(2, 50, 2, 32, 32, dec=dec, seed=5)
    proj = np.random.default_rng(6).standard_normal((2, 50, 2, 32)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jref.wkv6_reference(*a) * proj),
                    argnums=tuple(range(5)))(*_j(arrs))
    leaves = [x.requires_grad_() for x in _t(arrs)]
    o, _ = wk.wkv6(*leaves)
    got = torch.autograd.grad((o * torch.from_numpy(proj)).sum(), leaves)
    for g, jg in zip(got, want):
        _close(g, jg, GRAD_TOL)


@pytest.mark.parametrize("dec", [-1.0, 2.0])
def test_gradients_with_states_match_jax_grad(dec):
    """The init_state gradient, and a loss on the final state too."""
    arrs = _inputs(1, 45, 2, 32, 32, dec=dec, seed=7, init=True)
    rng = np.random.default_rng(8)
    po = rng.standard_normal((1, 45, 2, 32)).astype(np.float32)
    ps = rng.standard_normal((1, 2, 32, 32)).astype(np.float32)

    def jloss(*a):
        o, sT = _jax_wkv_with_state(*a)
        return jnp.sum(o * po) + jnp.sum(sT * ps)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*_j(arrs))
    leaves = [x.requires_grad_() for x in _t(arrs)]
    o, sT = wk.wkv6(*leaves)
    loss = (o * torch.from_numpy(po)).sum() + (sT * torch.from_numpy(ps)).sum()
    for g, jg in zip(torch.autograd.grad(loss, leaves), want):
        _close(g, jg, GRAD_TOL)


def test_decays_below_the_clip_get_zero_gradient():
    arrs = _inputs(1, 20, 1, 32, 32, dec=3.0, seed=9)  # w ~ 2e-9 < 1e-6
    leaves = [x.requires_grad_() for x in _t(arrs)]
    o, _ = wk.wkv6(*leaves)
    (dw,) = torch.autograd.grad(o.sum(), [leaves[3]])
    assert torch.isfinite(o).all() and not dw.any()


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    arrs = _t(_inputs(1, 30, 2, 32, 32, seed=10))
    before = dict(wk.launches)
    o, state = ops.wkv(*arrs)
    want_o, want_state = wk.wkv6_plain(*arrs)
    assert torch.equal(o, want_o) and torch.equal(state, want_state)
    assert wk.launches == before


@pytest.mark.parametrize("case,err", [
    ("fp16", TypeError), ("mixed", TypeError), ("K48", ValueError),
    ("KneV", ValueError), ("strided", ValueError), ("state_bf16", TypeError)])
def test_kernel_input_checks_raise(case, err):
    """What the CUDA kernels cannot take raises rather than falls back
    (the checks are device-independent, so they run here on CPU tensors)."""
    K = 48 if case == "K48" else 32
    r, k, v, w, u, s0 = _t(_inputs(1, 8, 2, K, 64 if case == "KneV" else K, init=True))
    if case == "fp16":
        r, k, v, w = (x.half() for x in (r, k, v, w))
    elif case == "mixed":
        r = r.bfloat16()
    elif case == "strided":
        r = r.transpose(1, 2).contiguous().transpose(1, 2)  # same shape, (B, H, S, K) memory
    elif case == "state_bf16":
        s0 = s0.bfloat16()
    with pytest.raises(err):
        wk._check_kernel(r, k, v, w, u, s0)
    good = _t(_inputs(1, 8, 2, 32, 32, init=True))
    wk._check_kernel(*good)  # the accepted inputs pass


@pytest.mark.parametrize("which", ["r", "w", "init_state"])
def test_kernel_refuses_misaligned_bf16(which):
    """The bf16 kernels read r, k, v, w and the initial state 16 bytes at a
    time: a contiguous view that starts off a 16-byte boundary raises."""
    r, k, v, w, u, s0 = _t(_inputs(1, 8, 2, 32, 32, init=True))
    ins = dict(r=r.bfloat16(), k=k.bfloat16(), v=v.bfloat16(), w=w.bfloat16(), u=u, s0=s0)
    wk._check_kernel(*ins.values())
    key = "s0" if which == "init_state" else which
    flat = torch.empty(ins[key].numel() + 1, dtype=ins[key].dtype)
    shifted = flat[1:].view(ins[key].shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match=f"{which} 16-byte aligned"):
        wk._check_kernel(*{**ins, key: shifted}.values())
    fp32 = dict(r=r, k=k, v=v, w=w, u=u, s0=s0)
    wk._check_kernel(*{**fp32, key: shifted.float()}.values())  # fp32: no such need


def test_wrapper_constants_match_the_cuda_source():
    """``wkv6_chunked_grads_plain`` and the wrapper's buffers follow the
    kernels' chunk, sub-chunk and checkpoint interval: they must be the
    source's."""
    import re
    from pathlib import Path

    src = (Path(wk.__file__).parent / "csrc" / "wkv6.cu").read_text()
    assert int(re.search(r"constexpr int L = (\d+);", src).group(1)) == wk.KCHUNK
    assert int(re.search(r"constexpr int SUB = (\d+);", src).group(1)) == wk.SUB
    assert int(re.search(r"constexpr int SEG = (\d+);", src).group(1)) == wk.SEG


def test_other_devices_raise():
    """A device other than cuda, cpu and meta (which models the card: the
    registered operators' fake implementation gives the outputs' shapes)
    raises."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    arrs = [x.to("meta") for x in _t(_inputs(1, 4, 1, 32, 32))]
    o, sT = wk.wkv6(*arrs)
    assert (o.device.type, tuple(o.shape), tuple(sT.shape)) == ("meta", (1, 4, 1, 32),
                                                                (1, 1, 32, 32))
    mode = FakeTensorMode()
    with pytest.raises(ValueError, match="cuda or cpu"):
        wk.wkv6(*(FakeTensor(mode, t, torch.device("xpu")) for t in arrs))


@pytest.mark.parametrize("bad", ["u_shape", "v_shape", "state_shape"])
def test_shape_checks(bad):
    r, k, v, w, u, s0 = _t(_inputs(1, 8, 2, 32, 32, init=True))
    if bad == "u_shape":
        u = u[:1]
    elif bad == "v_shape":
        v = v[:, :4]
    else:
        s0 = s0[:, :1]
    with pytest.raises(ValueError):
        wk.wkv6(r, k, v, w, u, s0)


# ---- the bf16 kernels' formulas (``wkv6_chunked_grads_plain``) ----
#
# Held against autograd through ``wkv6_plain`` in fp32, at 1e-3 absolute and
# relative (both fp32; they differ only in summation order), over the
# kernels' sub-chunk (16) and chunk (64) edges, both head sizes, decays from
# mild (w 0.87) to below the 1e-6 clip (dec = 3), with and without an
# initial state and a loss on the final state.

def _with_states(S, K):
    """Whether a sweep case has an ``init_state`` and a ``dsT``: all four
    ways over the S sweep."""
    return (S + K // 32) % 2 == 1, (S // 16 + K // 32) % 2 == 0


def _chunked_case(S, K, dec, init, with_dsT, seed):
    arrs = _inputs(2, S, 2, K, K, dec=dec, seed=seed, init=init)
    rng = np.random.default_rng(seed + 1)
    do = rng.standard_normal((2, S, 2, K)).astype(np.float32)
    dsT = rng.standard_normal((2, 2, K, K)).astype(np.float32) if with_dsT else None
    return arrs, do, dsT


def _autograd_through_plain(arrs, do, dsT):
    leaves = [x.requires_grad_() for x in _t(arrs)]
    o, sT = wk.wkv6_plain(*leaves)
    loss = (o * torch.from_numpy(do)).sum()
    if dsT is not None:
        loss = loss + (sT * torch.from_numpy(dsT)).sum()
    grads = torch.autograd.grad(loss, leaves)
    return [o, sT, *grads] + ([None] if len(leaves) == 5 else [])


@pytest.mark.parametrize("dec", [-2.0, 0.0, 1.0, 3.0])
@pytest.mark.parametrize("K", [32, 64])
@pytest.mark.parametrize("S", [1, 16, 17, 63, 64, 65, 129])
def test_chunked_grads_plain_matches_autograd(S, K, dec):
    """o, final state, dr, dk, dv, dw, du and d init_state."""
    init, with_dsT = _with_states(S, K)
    arrs, do, dsT = _chunked_case(S, K, dec, init, with_dsT, seed=S * K)
    t = _t(arrs)
    got = wk.wkv6_chunked_grads_plain(*t[:5], t[5] if init else None, torch.from_numpy(do),
                                      None if dsT is None else torch.from_numpy(dsT))
    want = _autograd_through_plain(arrs, do, dsT)
    names = ["o", "final_state", "dr", "dk", "dv", "dw", "du", "d_init_state"]
    for name, g, w_ in zip(names, got, want):
        if w_ is None:
            assert g is None, name
            continue
        assert torch.isfinite(g).all(), name
        _close(g, w_.detach().numpy(), GRAD_TOL)


def test_chunked_grads_plain_covers_init_and_final_state_both_ways():
    """The S sweep above runs with and without ``init_state`` and ``dsT``."""
    combos = {_with_states(S, K) for S in (1, 16, 17, 63, 64, 65, 129) for K in (32, 64)}
    assert combos == {(False, False), (False, True), (True, False), (True, True)}


@pytest.mark.parametrize("S,dec", [(65, -1.0), (129, 1.0), (100, 2.0)])
def test_chunked_grads_plain_matches_jax_grad(S, dec):
    """Against jax.grad of the reference's sequential oracle (with an initial
    state and a loss on the final state), where it is safe at every decay."""
    arrs, do, dsT = _chunked_case(S, 32, dec, True, True, seed=S)

    def jloss(*a):
        o, sT = _jax_wkv_with_state(*a)
        return jnp.sum(o * do) + jnp.sum(sT * dsT)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*_j(arrs))
    t = _t(arrs)
    got = wk.wkv6_chunked_grads_plain(*t, torch.from_numpy(do), torch.from_numpy(dsT))
    for g, jg in zip(got[2:], want[:4] + (want[4], want[5])):
        _close(g, jg, GRAD_TOL)
    o, sT = _jax_wkv_with_state(*_j(arrs))
    _close(got[0], o, FWD_TOL)
    _close(got[1], sT, FWD_TOL)
