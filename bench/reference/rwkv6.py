"""Plain RWKV-6 ("Finch") language model [arXiv:2404.05892], as the port
computes it, in float32: the loss of one batch.

Per layer, pre-norm (RMS norm, the scale stored as its offset from 1):

    time mix:    x_n = x + (shift(x) - x) * sigmoid(mix_n)   for n in r, k, v, w, g
                 r, k, v, g = x_n W_n;  w = exp(-exp(w0 + tanh(x_w A) B))
                 o = WKV6(r, k, v, w, u);  out = (rmsnorm(o, ln_x) * silu(g)) W_o
    channel mix: k = relu(x_k W_k)^2;  out = sigmoid(x_r W_r) * (k W_v)

then a final RMS norm, the head and the mean cross-entropy.  Departures
from the published Finch block, which the port makes and the reference
follows: static token-shift mixes (no data-dependent LoRA on the mixes),
RMS norms in place of layer norms, ``ln_x`` an RMS norm over all of
``d_model`` rather than a group norm per head, and no norm after the
embedding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference import wkv6 as wkv_lib
from bench.reference.common import Leaf, Precision, checkpointed, lm_loss, rms_norm, token_shift

DECAY_RANK = 64


def schema(m: dict) -> dict:
    """``{path: Leaf}`` in the state tree's paths; ``m`` the configuration's
    ``model`` block."""
    L, D, F_ = m["num_layers"], m["d_model"], m["d_ff"]
    H, hd, V = m["num_heads"], m["d_head"], m["padded_vocab"]
    s = {"embed": Leaf((V, D), 0.02), "final_norm": Leaf((D,)),
         "lm_head": Leaf.normal((D, V), D)}
    layer = {
        "ln1": Leaf((D,)), "ln2": Leaf((D,)),
        "mix/cmix_k": Leaf((D,)), "mix/cmix_r": Leaf((D,)),
        "mix/cw_k": Leaf.normal((D, F_), D), "mix/cw_r": Leaf.normal((D, D), D),
        "mix/cw_v": Leaf.normal((F_, D), F_), "mix/ln_x": Leaf((D,)),
        "mix/u_bonus": Leaf((H, hd), 0.02), "mix/w0": Leaf((D,)),
        "mix/w_lora_a": Leaf((D, DECAY_RANK), 0.02), "mix/w_lora_b": Leaf((DECAY_RANK, D), 0.02),
        "mix/wo": Leaf.normal((H, hd, D), H * hd),
    }
    for n in "rkvwg":
        layer[f"mix/mix_{n}"] = Leaf((D,))
    for n in "rkvg":
        layer[f"mix/w{n}"] = Leaf.normal((D, H, hd), D)
    for path, leaf in layer.items():
        s[f"layers/{path}"] = Leaf((L,) + leaf.shape, leaf.std)
    return s


def _mix(x, xs, mu):
    return x + (xs - x) * torch.sigmoid(mu)


def _time_mix(p: dict, x: torch.Tensor, m: dict, prec: Precision, wkv) -> torch.Tensor:
    B, S, D = x.shape
    H, hd = m["num_heads"], m["d_head"]
    a = prec.act
    xs = token_shift(x)
    xr, xk, xv, xw, xg = (a(_mix(x, xs, p[f"mix_{n}"])) for n in "rkvwg")
    r, k, v, g = (prec.mm(xi, p[n].reshape(D, H * hd)) for xi, n in
                  ((xr, "wr"), (xk, "wk"), (xv, "wv"), (xg, "wg")))
    w = a(torch.exp(-torch.exp(p["w0"] + torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"])))
    r, k, v, w = (t.reshape(B, S, H, hd) for t in (r, k, v, w))
    o = a(wkv(r, k, v, w, p["u_bonus"])).reshape(B, S, D)
    o = a(a(rms_norm(o, p["ln_x"], m["norm_eps"])) * a(F.silu(g)))
    return prec.mm(o, p["wo"].reshape(H * hd, D))


def _channel_mix(p: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    a = prec.act
    xs = token_shift(x)
    k = a(torch.square(torch.relu(prec.mm(a(_mix(x, xs, p["cmix_k"])), p["cw_k"]))))
    r = a(torch.sigmoid(prec.mm(a(_mix(x, xs, p["cmix_r"])), p["cw_r"])))
    return a(r * prec.mm(k, p["cw_v"]))


def _block(h: torch.Tensor, p: dict, m: dict, prec: Precision, wkv) -> torch.Tensor:
    a = prec.act
    h = a(h + _time_mix(p["mix"], a(rms_norm(h, p["ln1"], m["norm_eps"])), m, prec, wkv))
    return a(h + _channel_mix(p["mix"], a(rms_norm(h, p["ln2"], m["norm_eps"])), prec))


def loss(params: dict, batch: dict, m: dict, prec: Precision, exact: bool = False) -> torch.Tensor:
    """The mean cross-entropy of ``batch`` (``tokens``, ``labels``).  Each
    layer is recomputed in the backward pass.  ``exact`` walks WKV-6 step
    by step (small sizes: the tests, the FLOP count) instead of in chunks."""
    wkv = wkv_lib.wkv6_steps if exact else wkv_lib.wkv6_chunked
    h = prec.act(params["embed"][batch["tokens"]])
    layers = params["layers"]
    parts = {k: (v.unbind(0) if not isinstance(v, dict) else {n: t.unbind(0) for n, t in v.items()})
             for k, v in layers.items()}
    for i in range(m["num_layers"]):
        p = {k: (v[i] if not isinstance(v, dict) else {n: t[i] for n, t in v.items()})
             for k, v in parts.items()}
        h = checkpointed(lambda x, q: _block(x, q, m, prec, wkv), h, p)
    h = prec.act(rms_norm(h, params["final_norm"], m["norm_eps"]))
    return lm_loss(h, params["lm_head"], batch["labels"], prec)
