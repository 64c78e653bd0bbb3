"""PowerSGD (``optim/grad_compression.py``) against the reference.

The five cases of ``tests/test_grad_compression.py`` run through both
packages on the same gradients, the reference's starting Q factors
carried into the port's state (its own come from a ``torch.Generator``).
QR may choose other column signs in the two packages; ``p qᵀ`` does not
depend on them, so the approximations and the error-feedback buffers
are compared (fp32, 1e-5 of the largest magnitude), not the factors.
Then ``powersgd_allreduce`` over 4 gloo ranks against the reference's
``shard_map`` on an Auto-axis (4, 1) mesh of forced host devices.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import grad_compression as ref_gc
from repro_torch.optim import grad_compression as gc

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TOL = 1e-5


def _pair(g_np, rank, seed=0):
    """(reference state, port state) with the reference's Q in both."""
    jg = {k: jnp.asarray(v) for k, v in g_np.items()}
    jst = ref_gc.init_state(jg, rank=rank, seed=seed)
    tst = gc.init_state({k: torch.as_tensor(v) for k, v in g_np.items()}, rank=rank)
    for k in g_np:
        tst[k]["q"] = torch.as_tensor(np.asarray(jst[k]["q"]))
    return jg, jst, {k: torch.as_tensor(v) for k, v in g_np.items()}, tst


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=TOL * max(np.abs(j).max(), 1.0))


CHECKED_ROUNDS = 3  # rounds held element by element; later ones drift apart in fp32


def _rounds(g_np, rank, n):
    """``n`` rounds through both packages: the first ``CHECKED_ROUNDS``
    approximations and error buffers held to ``TOL``.  Past them the error
    buffers, fed back round after round through QR in two libraries, part
    by more (1.1e-4 of the largest magnitude after 30 rounds of a 24 x 24
    gradient), so later rounds are compared through what they compute."""
    jg, jst, tg, tst = _pair(g_np, rank)
    outs = []
    for i in range(n):
        japp, jst = ref_gc.compress_decompress(jg, jst, rank=rank)
        tapp, tst = gc.compress_decompress(tg, tst, rank=rank)
        if i < CHECKED_ROUNDS:
            for k in g_np:
                _close(tapp[k], japp[k])
                _close(tst[k]["err"], jst[k]["err"])
        outs.append((tapp, japp))
    return outs


def test_low_rank_exact_for_low_rank_matrix():
    rng = np.random.default_rng(0)
    g = {"w": (rng.standard_normal((32, 2)) @ rng.standard_normal((2, 16))).astype(np.float32)}
    tapp, _ = _rounds(g, 4, 3)[-1]
    err = torch.linalg.norm(tapp["w"] - torch.as_tensor(g["w"])) / np.linalg.norm(g["w"])
    assert float(err) < 1e-3


def test_error_feedback_accumulates():
    rng = np.random.default_rng(1)
    g = {"w": rng.standard_normal((24, 24)).astype(np.float32)}
    one = _rounds(g, 2, 1)[0][0]["w"]
    tw = torch.as_tensor(g["w"])
    err_one = float(torch.linalg.norm(one - tw) / torch.linalg.norm(tw))
    K = 30
    outs = _rounds(g, 2, K)
    total = sum(t["w"] for t, _ in outs)
    err = float(torch.linalg.norm(total / K - tw) / torch.linalg.norm(tw))
    assert err < err_one * 0.5 and err < 0.3
    ref_total = sum(np.asarray(j["w"]) for _, j in outs)
    ref_err = np.linalg.norm(ref_total / K - g["w"]) / np.linalg.norm(g["w"])
    assert abs(err - ref_err) < 1e-4 * ref_err


def test_rank_improves_fidelity():
    rng = np.random.default_rng(2)
    g = {"w": rng.standard_normal((32, 32)).astype(np.float32)}
    errs = [float(torch.linalg.norm(_rounds(g, r, 2)[-1][0]["w"] - torch.as_tensor(g["w"])))
            for r in (1, 4, 16)]
    assert errs[0] > errs[1] > errs[2]


def test_small_leaves_exact():
    g = {"b": np.arange(3.0, dtype=np.float32)}
    tapp, _ = _rounds(g, 4, 1)[0]
    np.testing.assert_array_equal(tapp["b"].numpy(), g["b"])


def test_compression_ratio():
    params = {"w": jnp.zeros((1024, 1024)), "b": jnp.zeros((4,)), "e": jnp.zeros((8, 3, 5))}
    got = gc.compression_ratio({k: torch.zeros(v.shape) for k, v in params.items()}, rank=4)
    assert got == ref_gc.compression_ratio(params, rank=4)
    assert gc.compression_ratio({"w": torch.zeros(1024, 1024), "b": torch.zeros(4)}) < 0.02


def test_init_state_draws_every_leaf_from_the_seed():
    p = {"b": torch.zeros(3), "a": {"w": torch.zeros(5, 7)}}
    s1, s2 = gc.init_state(p, rank=2, seed=3), gc.init_state(p, rank=2, seed=3)
    assert s1["a"]["w"]["q"].shape == (7, 2) and s1["b"]["q"].shape == (3, 2)
    assert torch.equal(s1["a"]["w"]["q"], s2["a"]["w"]["q"])
    assert not s1["a"]["w"]["err"].any()


REF_SHARD_MAP = """
import sys, numpy as np, jax, jax.numpy as jnp
from functools import partial
from jax.sharding import Mesh, PartitionSpec as P
from repro.optim.grad_compression import init_state, powersgd_allreduce
mesh = Mesh(np.array(jax.devices()[:4]).reshape(4, 1), ("data", "model"))
g_global = jax.random.normal(jax.random.PRNGKey(0), (4, 32, 16))
st = init_state({"w": jnp.zeros((32, 16))}, rank=8)

@partial(jax.shard_map, mesh=mesh, in_specs=(P("data"), P(None)),
         out_specs=(P("data"), P(None)))
def run(g, q):
    gs = {"w": g[0]}
    state = {"w": {"q": q, "err": jnp.zeros((32, 16))}}
    total = jnp.zeros((32, 16))
    for _ in range(8):
        approx, state = powersgd_allreduce(gs, state, axis="data", rank=8)
        total = total + approx["w"]
    return (total / 8)[None], state["w"]["q"]

avg, _ = run(g_global, st["w"]["q"])
np.savez(sys.argv[1] + "/psgd-in.npz", g_global=np.asarray(g_global),
         q=np.asarray(st["w"]["q"]))
np.save(sys.argv[1] + "/psgd-avg.npy", np.asarray(avg))
"""


@pytest.fixture(scope="module")
def allreduce(tmp_path_factory):
    ref = str(tmp_path_factory.mktemp("psgd"))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_SHARD_MAP), ref],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    out = os.path.join(ref, "port")
    case = {"psgd": {"kind": "powersgd", "iters": 8, "rank": 8}}
    r = subprocess.run([sys.executable, os.path.join(HERE, "_dist_ranks.py"), ref, out,
                        "[4, 1]", json.dumps(case)], capture_output=True, text=True,
                       timeout=300, env=dict(env, XLA_FLAGS=""))
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(os.path.join(ref, "psgd-avg.npy"))
    got = np.stack([np.load(os.path.join(out, f"psgd-avg-{i}.npy")) for i in range(4)])
    g_global = np.load(os.path.join(ref, "psgd-in.npz"))["g_global"]
    return got, want, g_global


def test_powersgd_allreduce_synchronises_the_ranks(allreduce):
    got, _, _ = allreduce
    assert float(np.abs(got - got[0:1]).max()) < 1e-5


def test_powersgd_allreduce_approaches_the_mean_as_the_reference(allreduce):
    """The same error bound as the reference's test, and the same running
    mean as its ``shard_map`` run (1e-4 of the largest magnitude: 8 rounds
    of QR in another library)."""
    got, want, g_global = allreduce
    mean = g_global.mean(axis=0)
    err = np.linalg.norm(got[0] - mean) / np.linalg.norm(mean)
    ref_err = np.linalg.norm(want[0] - mean) / np.linalg.norm(mean)
    assert err < 0.6 and abs(err - ref_err) < 1e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
