"""Weight bridge: the reference's checkpoint format -> the port's params.

``repro/checkpoint/ckpt.py`` saves one ``step_<N>/arrays.npz`` of the
flattened pytree ('/'-joined key paths, numpy arrays) plus ``meta.json``.
``params_from_numpy`` turns such a flat mapping into the port's nested
dicts of tensors (same paths, same shapes, same dtypes);
``load_reference_checkpoint`` reads a saved step.  Every parity test
carries the reference's weights over through here, since JAX's PRNG cannot
be reproduced in PyTorch.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

_SEP = "/"


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {'a/b/c': leaf}, the reference's key layout."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}{_SEP}{k}" if prefix else str(k)))
    return out


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.require(arr, requirements=["C", "W"])  # copies only if needed
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16, as JAX hands it out
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(flat: Mapping[str, np.ndarray],
                      device: DeviceLike = None) -> dict:
    """{'layers/attn/wq': array, ...} -> nested dicts of tensors on ``device``."""
    dev = resolve_device(device)
    out: dict = {}
    for key, arr in flat.items():
        node = out
        *parents, leaf = key.split(_SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _tensor(arr, dev)
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", name))
             and os.path.exists(os.path.join(ckpt_dir, name, "meta.json"))]
    return max(steps) if steps else None


def load_reference_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                              device: DeviceLike = None) -> Tuple[dict, dict]:
    """Read ``step_<N>/arrays.npz`` + ``meta.json`` written by the
    reference's ``save`` (the latest step by default); returns
    ``(tree, meta)`` with the tree as nested dicts of tensors."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_numpy(flat, device), meta
