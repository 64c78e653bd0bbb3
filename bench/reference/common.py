"""What every plain reference shares: the weights made from the seed, the
precision the products run in, the numerics helpers, the blocked
cross-entropy and AdamW.

Plain PyTorch in float32 with TF32 off; it imports nothing of the program.
``Precision("fp8")`` is the control: every activation the program holds in
bfloat16 (the residual stream, each norm's, mix's, product's and kernel's
output) and every operand of a matrix product rounded to float8 e4m3
(scaled per tensor by its largest magnitude), and so their gradients in
the backward pass; what the program holds in float32 (norm statistics,
the decay, the loss, master weights, the optimizer) stays float32.
``Precision("bf16")`` rounds the same values to bfloat16: a witness of
what the program's own rounding does.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

F32 = torch.float32
E4M3_MAX = 448.0


# --- weights ----------------------------------------------------------------


@dataclass(frozen=True)
class Leaf:
    """One parameter of a reference schema: its shape and how it is drawn
    (``zeros``, or a normal of standard deviation ``std``)."""

    shape: tuple
    std: float = 0.0  # 0: zeros

    @staticmethod
    def normal(shape: tuple, fan_in: int) -> "Leaf":
        return Leaf(tuple(shape), 1.0 / math.sqrt(fan_in))


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one stream drawn from ``seed`` (any whole number)."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def make_leaf(spec: Leaf, seed: int, path: str, device) -> torch.Tensor:
    """The leaf at ``path`` for ``seed``, in float32 on ``device``: one draw
    from a generator of its own, so any leaf can be made again alone."""
    if spec.std == 0.0:
        return torch.zeros(spec.shape, dtype=F32, device=device)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights", path))
    out = torch.randn(spec.shape, generator=g, dtype=F32, device=device)
    return out.mul_(spec.std)


def flat_paths(tree, prefix: str = "") -> Dict[str, object]:
    """``{"a/b/c": leaf}`` in sorted key order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat_paths(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def nest(flat: Dict[str, object]) -> dict:
    tree: dict = {}
    for path, x in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return tree


# --- precision ----------------------------------------------------------------


def _q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in fp32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale


def _q16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, back in fp32."""
    return x.to(torch.bfloat16).to(F32)


ROUND = {"fp8": _q8, "bf16": _q16}


class _Round(torch.autograd.Function):
    """Rounds forward, and the incoming gradient backward."""

    @staticmethod
    def forward(ctx, x, q):
        ctx.q = q
        return q(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.q(g), None


class _Matmul(torch.autograd.Function):
    """``a @ b`` with both operands and the product rounded, and in the
    backward the gradient, the saved operands and both gradients rounded;
    fp32 accumulation."""

    @staticmethod
    def forward(ctx, a, b, q):
        a8, b8 = q(a), q(b)
        ctx.save_for_backward(a8, b8)
        ctx.q = q
        return q(a8 @ b8)

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = ctx.q(g)
        ga = g8 @ b8.transpose(-1, -2)
        gb = a8.transpose(-1, -2) @ g8
        while gb.dim() > b8.dim():  # a batched activation times a weight matrix
            gb = gb.sum(0)
        return ctx.q(ga), ctx.q(gb), None


@dataclass(frozen=True)
class Precision:
    """``fp32``: the reference; ``fp8``: the control; ``bf16``: the
    witness.  ``mm`` is a matrix product, ``act`` an activation."""

    name: str = "fp32"

    def __post_init__(self):
        if self.name not in ("fp32", *ROUND):
            raise ValueError(f"precision {self.name!r}: fp32, {', '.join(ROUND)}")

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name in ROUND:
            return _Matmul.apply(a, b, ROUND[self.name])
        return a @ b

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _Round.apply(x, ROUND[self.name]) if self.name in ROUND else x


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --- numerics ------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``x / rms(x) * (1 + scale)`` over the last axis (the scale stored as
    its offset from 1)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)


def token_shift(x: torch.Tensor) -> torch.Tensor:
    """The previous position's features, zeros at position 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def checkpointed(fn: Callable, *args):
    """``fn(*args)``, its activations recomputed in the backward pass."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _xent_sum(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, prec: Precision,
              transpose: bool) -> torch.Tensor:
    logits = prec.mm(h, w.t() if transpose else w)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return (torch.logsumexp(logits, -1) - gold).sum()


def lm_loss(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, prec: Precision,
            transpose: bool = False, rows: int = 4096) -> torch.Tensor:
    """The mean over every position of ``logsumexp(logits) - logits[label]``,
    ``logits = h @ w`` (``h @ w.T`` with ``transpose``), over blocks of
    ``rows`` positions at a time, each recomputed in the backward pass, so
    no whole logits tensor exists."""
    h = h.reshape(-1, h.shape[-1])
    labels = labels.reshape(-1)
    total = h.new_zeros(())
    for i in range(0, h.shape[0], rows):
        total = total + checkpointed(
            lambda a, b, c: _xent_sum(a, b, c, prec, transpose), h[i:i + rows], w,
            labels[i:i + rows])
    return total / h.shape[0]


# --- AdamW ---------------------------------------------------------------------


def cosine_lr(step: int, opt: dict) -> float:
    peak, total = opt["peak_lr"], opt["total_steps"]
    warmup = opt["warmup_steps"]
    floor = opt["floor_frac"]
    if step < warmup:
        return peak * min(step / max(warmup, 1), 1.0)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * t)))


class AdamW:
    """AdamW with global-norm clipping first, decoupled weight decay on
    leaves of two or more axes, and bias correction, as the configuration
    states it (``opt``)."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: dict):
        self.opt = opt
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               scale_batch: Optional[float] = None) -> Dict[str, torch.Tensor]:
        """Updates ``params`` in place; returns the clipped gradients'
        per-leaf norms."""
        o = self.opt
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        clip = torch.clamp(o["max_grad_norm"] / (norm + 1e-9), max=1.0)
        self.count += 1
        lr = cosine_lr(self.count, o)
        b1, b2 = o["b1"], o["b2"]
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        norms = {}
        for k, p in params.items():
            g = grads[k] * clip
            norms[k] = float(torch.linalg.vector_norm(g))
            m, v = self.m[k], self.v[k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            step = (m / bc1) / (torch.sqrt(v / bc2) + o["eps"])
            if p.dim() >= 2:
                step.add_(p, alpha=o["weight_decay"])
            p.sub_(lr * step)
        return norms
