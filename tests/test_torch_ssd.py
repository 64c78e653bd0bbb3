"""The port's SSD scan (``repro_torch.kernels.ssd_scan``) against the reference.

On the CPU the wrapper takes ``ssd_plain``, the kernel's plain version; it
is held against the reference's sequential oracle ``ssd_reference``, its
chunked form ``models/mamba2.ssd_chunked`` (initial and final state
included) and its Pallas kernel in interpret mode, and its gradients
against ``jax.grad`` of ``ssd_chunked``.  Tolerances, absolute and
relative, all in fp32: 1e-4 forward (sums of up to a few hundred terms
taken in another order), 1e-3 on gradients.

Decays are ``exp(dt A)`` with ``A = -exp(A_log)`` and ``dt = softplus(.)``,
as ``mamba2_apply`` makes them.  ``A_log = 2`` with ``dt`` near 1.3 gives
``exp(-10)`` per step: the Pallas kernel's ``exp`` before the mask reaches
``exp(+600)`` above the diagonal there; the port masks first and stays
finite and exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.models.mamba2 import ssd_chunked as ref_ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as ss

FWD_TOL = 1e-4
GRAD_TOL = 1e-3


def _inputs(B, S, H, P, N, *, a_log=0.0, dt_mean=0.0, seed=0, init=False):
    """numpy x, dt, A, Bm, Cm (and init state), fp32: dt = softplus(dt_mean
    + 0.5 noise), A = -exp(a_log + 0.1 noise)."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(dt_mean + 0.5 * rng.standard_normal((B, S, H))))
    A = -np.exp(a_log + 0.1 * rng.standard_normal(H))
    Bm, Cm = (0.5 * rng.standard_normal((B, S, N)) for _ in range(2))
    out = [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]
    if init:
        out.append((0.5 * rng.standard_normal((B, H, P, N))).astype(np.float32))
    return out


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("S,P,N", [(64, 16, 8), (128, 32, 16), (192, 8, 32)])
def test_plain_matches_reference_forms(S, P, N):
    arrs = _inputs(2, S, 3, P, N, seed=S + P + N)
    y, state = ss.ssd_plain(*_t(arrs))
    want_seq = jref.ssd_reference(*_j(arrs))
    want_chunk, want_state = ref_ssd_chunked(*_j(arrs), chunk=64)
    want_pallas = ref_ops.ssd(*_j(arrs), chunk=64, force="pallas_interpret")
    for want in (want_seq, want_chunk, want_pallas):
        _close(y, want, FWD_TOL)
    _close(state, want_state, FWD_TOL)


def test_plain_matches_chunked_with_init_state():
    arrs = _inputs(2, 128, 2, 16, 8, seed=11, init=True)
    y, state = ss.ssd_plain(*_t(arrs))
    want_y, want_state = ref_ssd_chunked(*_j(arrs[:5]), chunk=128,
                                         init_state=jnp.asarray(arrs[5]))
    _close(y, want_y, FWD_TOL)
    _close(state, want_state, FWD_TOL)


@pytest.mark.parametrize("S", [1, 17, 100])
def test_plain_any_length(S):
    """Ragged S (the reference's chunked forms need multiples of the chunk)."""
    arrs = _inputs(1, S, 2, 8, 8, seed=S, init=True)
    y, state = ss.ssd_plain(*_t(arrs))
    want_y, want_state = tref.ssd_reference(*_t(arrs))
    _close(y, want_y.numpy(), FWD_TOL)
    _close(state, want_state.numpy(), FWD_TOL)


def test_port_oracle_matches_reference_oracle():
    arrs = _inputs(2, 40, 2, 8, 4, seed=4)
    y, _ = tref.ssd_reference(*_t(arrs))
    _close(y, jref.ssd_reference(*_j(arrs)), 1e-5)


@pytest.mark.parametrize("a_log,dt_mean", [(2.0, 1.0), (3.0, 2.0)])
def test_strong_decays_stay_finite_and_exact(a_log, dt_mean):
    """exp(dt A) of about exp(-10) and exp(-40) per step: finite, and equal
    to the sequential oracle, values and gradients alike."""
    arrs = _inputs(1, 128, 2, 16, 8, a_log=a_log, dt_mean=dt_mean, seed=3, init=True)
    leaves = [x.requires_grad_() for x in _t(arrs)]
    y, state = ss.ssd_plain(*leaves)
    want_y, want_state = tref.ssd_reference(*_t(arrs))
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    _close(y, want_y.numpy(), FWD_TOL)
    _close(state, want_state.numpy(), FWD_TOL)
    proj = torch.from_numpy(np.random.default_rng(5).standard_normal(y.shape).astype(np.float32))
    got = torch.autograd.grad((y * proj).sum() + state.sum(), leaves)
    ref_leaves = [x.requires_grad_() for x in _t(arrs)]
    ry, rstate = tref.ssd_reference(*ref_leaves)
    want = torch.autograd.grad((ry * proj).sum() + rstate.sum(), ref_leaves)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w.numpy(), GRAD_TOL)


@pytest.mark.parametrize("split", [37, 64])
def test_state_handoff(split):
    """Two parts with the state carried between them equal the whole
    sequence; the final state matches the reference's chunked form."""
    x, dt, A, Bm, Cm, s0 = _t(_inputs(2, 128, 3, 8, 8, seed=split, init=True))
    y, state = ops.ssd(x, dt, A, Bm, Cm, s0)
    y1, s1 = ops.ssd(x[:, :split], dt[:, :split], A, Bm[:, :split], Cm[:, :split], s0)
    y2, s2 = ops.ssd(x[:, split:], dt[:, split:], A, Bm[:, split:], Cm[:, split:], s1)
    _close(torch.cat([y1, y2], 1), y.numpy(), FWD_TOL)
    _close(s2, state.numpy(), FWD_TOL)
    jy, jstate = ref_ssd_chunked(*_j([t.numpy() for t in (x, dt, A, Bm, Cm)]), chunk=64,
                                 init_state=jnp.asarray(s0.numpy()))
    _close(y, jy, FWD_TOL)
    _close(state, jstate, FWD_TOL)


@pytest.mark.parametrize("a_log,dt_mean,init", [(0.0, 0.0, False), (0.0, 0.0, True),
                                                (2.0, 1.0, True)])
def test_gradients_match_jax_grad(a_log, dt_mean, init):
    """d/d(x, dt, A, Bm, Cm, init_state) of <y, P> + <final, Q> against
    jax.grad of the reference's ``ssd_chunked``; the model's initial decays
    (A = -1, dt about 0.69) and strong ones."""
    arrs = _inputs(2, 128, 2, 8, 8, a_log=a_log, dt_mean=dt_mean, seed=6, init=init)
    rng = np.random.default_rng(7)
    py = rng.standard_normal((2, 128, 2, 8)).astype(np.float32)
    ps = rng.standard_normal((2, 2, 8, 8)).astype(np.float32)

    def jloss(*a):
        y, sT = ref_ssd_chunked(*a[:5], chunk=64, init_state=a[5] if init else None)
        return jnp.sum(y * py) + jnp.sum(sT * ps)

    want = jax.grad(jloss, argnums=tuple(range(len(arrs))))(*_j(arrs))
    leaves = [x.requires_grad_() for x in _t(arrs)]
    y, sT = ss.ssd(*leaves)
    loss = (y * torch.from_numpy(py)).sum() + (sT * torch.from_numpy(ps)).sum()
    got = torch.autograd.grad(loss, leaves)
    assert len(got) == len(want)
    for g, jg in zip(got, want):
        _close(g, jg, GRAD_TOL)


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    arrs = _t(_inputs(1, 30, 2, 8, 8, seed=10))
    before = dict(ss.launches)
    y, state = ops.ssd(*arrs)
    want_y, want_state = ss.ssd_plain(*arrs)
    assert torch.equal(y, want_y) and torch.equal(state, want_state)
    assert ss.launches == before


@pytest.mark.parametrize("case,err", [
    ("fp16", TypeError), ("mixed", TypeError), ("dt_bf16", TypeError), ("A_bf16", TypeError),
    ("P48", ValueError), ("N128", ValueError), ("strided", ValueError),
    ("state_bf16", TypeError)])
def test_kernel_input_checks_raise(case, err):
    """What the CUDA kernels cannot take raises rather than falls back
    (the checks are device-independent, so they run here on CPU tensors)."""
    P = 48 if case == "P48" else 32
    N = 128 if case == "N128" else 64
    x, dt, A, Bm, Cm, s0 = _t(_inputs(1, 8, 2, P, N, init=True))
    if case == "fp16":
        x, Bm, Cm = (t.half() for t in (x, Bm, Cm))
    elif case == "mixed":
        x = x.bfloat16()
    elif case == "dt_bf16":
        dt = dt.bfloat16()
    elif case == "A_bf16":
        A = A.bfloat16()
    elif case == "strided":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)  # same shape, (B, H, S, P) memory
    elif case == "state_bf16":
        s0 = s0.bfloat16()
    with pytest.raises(err):
        ss._check_kernel(x, dt, A, Bm, Cm, s0)
    for P, N in ((32, 16), (64, 64)):
        good = _t(_inputs(1, 8, 2, P, N, init=True))
        ss._check_kernel(*good)  # the accepted inputs pass
        ss._check_kernel(*[t.bfloat16() if i in (0, 3, 4) else t for i, t in enumerate(good)])


def test_other_devices_raise():
    """A device other than cuda, cpu and meta (which models the card: the
    registered operators' fake implementation gives the outputs' shapes)
    raises."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    arrs = [t.to("meta") for t in _t(_inputs(1, 4, 1, 32, 16))]
    y, sT = ss.ssd(*arrs)
    assert (y.device.type, tuple(y.shape), tuple(sT.shape)) == ("meta", (1, 4, 1, 32),
                                                                 (1, 1, 32, 16))
    mode = FakeTensorMode()
    with pytest.raises(ValueError, match="cuda or cpu"):
        ss.ssd(*(FakeTensor(mode, t, torch.device("xpu")) for t in arrs))


@pytest.mark.parametrize("bad", ["dt_shape", "A_shape", "C_shape", "state_shape"])
def test_shape_checks(bad):
    x, dt, A, Bm, Cm, s0 = _t(_inputs(1, 8, 2, 8, 8, init=True))
    if bad == "dt_shape":
        dt = dt[:, :4]
    elif bad == "A_shape":
        A = A[:1]
    elif bad == "C_shape":
        Cm = Cm[..., :4]
    else:
        s0 = s0[:, :1]
    with pytest.raises(ValueError):
        ss.ssd(x, dt, A, Bm, Cm, s0)


# --- the bf16 kernels' chunked backward, in plain PyTorch ---------------------

CHUNK_CASES = [(S, init, a_log, dt_mean) for S in (1, 63, 65, 129) for init in (False, True)
               for a_log, dt_mean in ((0.0, 0.0), (2.0, 1.0), (3.0, 2.0))]


def _seq(x, dt, A, Bm, Cm, s0):
    """The sequential recurrence in the inputs' dtype (the fp64 oracle)."""
    Bsz, S, H, P = x.shape
    h = torch.zeros((Bsz, H, P, Bm.shape[-1]), dtype=x.dtype) if s0 is None else s0
    ys = []
    for t in range(S):
        h = (h * torch.exp(dt[:, t] * A)[..., None, None]
             + (x[:, t] * dt[:, t, :, None])[..., None] * Bm[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, 1), h


def _chunk_case(S, init, a_log, dt_mean):
    arrs = _inputs(2, S, 2, 8, 8, a_log=a_log, dt_mean=dt_mean, seed=100 + S, init=init)
    rng = np.random.default_rng(S)
    dy = rng.standard_normal((2, S, 2, 8)).astype(np.float32)
    dsT = rng.standard_normal((2, 2, 8, 8)).astype(np.float32)
    return arrs, dy, dsT


def _autograd(fn, arrs, dy, dsT):
    leaves = [t.requires_grad_() for t in arrs]
    y, sT = fn(*leaves[:5], leaves[5] if len(leaves) > 5 else None)
    return torch.autograd.grad((y * dy).sum() + (sT * dsT).sum(), leaves)


@pytest.mark.parametrize("S,init,a_log,dt_mean", CHUNK_CASES)
def test_chunked_grads_plain_fp64_matches_the_oracle(S, init, a_log, dt_mean):
    """In fp64 the bf16 backward's formulas (chunk states, the reverse state
    pass, the in-chunk products with span-sum exponents) equal autograd
    through the sequential recurrence to rounding: ragged S, with and
    without an initial state, decays down to exp(-40) a step."""
    arrs, dy, dsT = _chunk_case(S, init, a_log, dt_mean)
    t64 = [torch.from_numpy(a).double() for a in arrs]
    dy64, dsT64 = torch.from_numpy(dy).double(), torch.from_numpy(dsT).double()
    got = ss.ssd_chunked_grads_plain(*t64[:5], t64[5] if init else None, dy64, dsT64)
    want = _autograd(_seq, [t.clone() for t in t64], dy64, dsT64)
    got = [g for g in got if g is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-10, rtol=1e-9)


@pytest.mark.parametrize("S,init,a_log,dt_mean", CHUNK_CASES)
def test_chunked_grads_plain_fp32_matches_autograd_and_jax(S, init, a_log, dt_mean):
    """In fp32 the same formulas agree with autograd through ``ssd_plain``
    and with ``jax.grad`` of the reference's ``ssd_chunked`` (its inputs
    padded to whole chunks with dt = 0 steps, which change nothing)."""
    arrs, dy, dsT = _chunk_case(S, init, a_log, dt_mean)
    t32 = _t(arrs)
    got = ss.ssd_chunked_grads_plain(*t32[:5], t32[5] if init else None,
                                     torch.from_numpy(dy), torch.from_numpy(dsT))
    got = [g for g in got if g is not None]
    want = _autograd(ss.ssd_plain, [t.clone() for t in t32], torch.from_numpy(dy),
                     torch.from_numpy(dsT))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w.numpy(), GRAD_TOL)

    pad = (-S) % 64
    padded = [a if i == 2 else np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              for i, a in enumerate(arrs[:5])]  # A has no time axis
    dy_p = np.pad(dy, [(0, 0), (0, pad), (0, 0), (0, 0)])

    def jloss(*a):
        y, sT = ref_ssd_chunked(*a[:5], chunk=64, init_state=a[5] if init else None)
        return jnp.sum(y * dy_p) + jnp.sum(sT * dsT)

    jin = _j(padded + ([arrs[5]] if init else []))
    jgrads = jax.grad(jloss, argnums=tuple(range(len(jin))))(*jin)
    for i, (g, jg) in enumerate(zip(got, jgrads)):
        jg = np.asarray(jg)
        if i in (0, 1, 3, 4):  # time-major inputs: the real steps only
            jg = jg[:, :S]
        _close(g, jg, GRAD_TOL)


def test_kernel_refuses_misaligned_bf16():
    """The bf16 kernels read x, Bm, Cm and the initial state 16 bytes at a
    time: a contiguous view that starts off a 16-byte boundary raises."""
    x, dt, A, Bm, Cm, s0 = _t(_inputs(1, 8, 2, 32, 16, init=True))
    x, Bm, Cm = (t.bfloat16() for t in (x, Bm, Cm))
    ss._check_kernel(x, dt, A, Bm, Cm, s0)
    flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(x.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        ss._check_kernel(shifted, dt, A, Bm, Cm, s0)
    ss._check_kernel(shifted.float(), dt, A, Bm.float(), Cm.float(), s0)  # fp32: no such need


def test_wrapper_constants_match_the_cuda_source():
    """The wrapper sizes the bf16 kernels' buffers by the chunk and the heads
    a CTA holds: they must be the source's."""
    import re
    from pathlib import Path

    src = (Path(ss.__file__).parent / "csrc" / "ssd_scan.cu").read_text()
    assert int(re.search(r"constexpr int L = (\d+);", src).group(1)) == ss.CHUNK
    assert int(re.search(r"constexpr int HG = (\d+);", src).group(1)) == ss.HEAD_GROUP
    assert int(re.search(r"constexpr int SEG = (\d+);", src).group(1)) == ss.SEG
