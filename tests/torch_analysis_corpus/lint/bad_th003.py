"""Corpus: Python assert over tensor values (a device sync each)."""
import torch


def loss(w, x):
    y = x @ w
    assert torch.isfinite(y).all(), "non-finite activations"  # flagged
    assert y.sum().item() > 0  # flagged
    assert y.shape[0] == x.shape[0]  # shapes live on the host: not flagged
    return y
