"""Checkpoints in the reference's format, and the weight bridge.

``repro/checkpoint/ckpt.py`` saves one ``step_<N>/arrays.npz`` of the
flattened pytree ('/'-joined key paths, numpy arrays) plus ``meta.json``.
``save`` and ``restore`` are its port: atomic (written to
``step_<N>.tmp/``, then renamed), optionally on a background thread, the
oldest beyond ``keep`` garbage-collected; a checkpoint saved by either
package restores in the other.  ``params_from_numpy`` turns such a flat
mapping into the port's nested dicts of tensors (same paths, shapes and
dtypes); ``load_reference_checkpoint`` reads a saved step without a
template.  Every parity test carries the reference's weights over through
here, since JAX's PRNG cannot be reproduced in PyTorch.

A sharded state (DTensor leaves) saves in the same format: every rank
gathers each leaf (``full_tensor``, a collective) and rank 0 writes.
``restore(..., shardings=)`` places every leaf by the *target* mesh's
shardings, whatever mesh saved it: the elastic restore onto a re-carved
mesh.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
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


def _unflatten(flat: Mapping[str, Any]) -> dict:
    """{'a/b/c': leaf} -> nested dicts (the inverse of ``flatten``)."""
    out: dict = {}
    for key, leaf in flat.items():
        node = out
        *parents, last = key.split(_SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def params_from_numpy(flat: Mapping[str, np.ndarray],
                      device: DeviceLike = None) -> dict:
    """{'layers/attn/wq': array, ...} -> nested dicts of tensors on ``device``."""
    dev = resolve_device(device)
    return _unflatten({k: _tensor(arr, dev) for k, arr in flat.items()})


def _steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(r"step_(\d+)", name))
                  and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in _steps(ckpt_dir)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"), ignore_errors=True)


def _numpy(t: torch.Tensor) -> np.ndarray:
    if hasattr(t, "full_tensor"):  # a DTensor: gathered on every rank
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        raise TypeError("bfloat16 leaves have no numpy dtype here; the reference "
                        "format holds training state in float32")
    return t.detach().cpu().numpy()


def save(ckpt_dir: str, state: Any, step: int, *, keep: int = 3,
         extra_meta: Optional[dict] = None, async_: bool = True) -> threading.Thread:
    """Checkpoint ``state`` (nested dicts of tensors) at ``step``.  The copy
    to the host is synchronous; writing the files runs on the returned
    thread (joined here unless ``async_``).  In a process group every rank
    calls it (DTensor leaves are gathered) and rank 0 alone writes; a
    synchronous save returns once it is written, on every rank."""
    import torch.distributed as dist

    group = dist.is_available() and dist.is_initialized()
    host = {k: _numpy(v) for k, v in flatten(state).items()}
    meta = {"step": int(step), "time": time.time(), **(extra_meta or {})}

    def _write():
        tmp = os.path.join(ckpt_dir, f"step_{step:010d}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    writer = not group or dist.get_rank() == 0
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
    t = threading.Thread(target=_write if writer else (lambda: None), daemon=True)
    t.start()
    if not async_:
        t.join()
        if group:
            dist.barrier()
    return t


def restore(ckpt_dir: str, like: Any, *, step: Optional[int] = None,
            shardings: Any = None) -> Tuple[Any, dict]:
    """Restore into the structure of ``like`` (nested dicts of tensors, or
    of ``meta`` tensors such as ``train.state.abstract_state``): every leaf
    comes back with ``like``'s dtype and ``requires_grad``; shapes must
    match.  With ``shardings`` (a ``dist.sharding.NamedSharding`` tree)
    each leaf is placed as a DTensor by its target sharding, each rank
    cutting its own shard from the file (the elastic restart); a 0-d leaf
    stays a plain tensor, on ``like``'s device (the CPU for a ``meta``
    leaf).  Without, on ``like``'s device.  Returns ``(tree, meta)``."""
    from repro_torch.dist.sharding import device_put

    path, meta = _open(ckpt_dir, step)
    flat = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, leaf in flatten(like).items():
            if key not in data:
                raise KeyError(f"checkpoint {path} missing {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: ckpt shape {arr.shape} != state {tuple(leaf.shape)}")
            dev = torch.device("cpu") if leaf.device.type == "meta" else leaf.device
            t = _tensor(arr, dev).to(leaf.dtype)
            flat[key] = t.requires_grad_(leaf.requires_grad)
    tree = _unflatten(flat)
    if shardings is not None:
        tree = device_put(tree, shardings)
    return tree, meta


def _open(ckpt_dir: str, step: Optional[int]) -> Tuple[str, dict]:
    """(directory, meta) of ``step`` (default: the latest) in ``ckpt_dir``."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "meta.json")) as f:
        return path, json.load(f)


def load_reference_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                              device: DeviceLike = None) -> Tuple[dict, dict]:
    """Read ``step_<N>/arrays.npz`` + ``meta.json`` written by the
    reference's ``save`` (the latest step by default); returns
    ``(tree, meta)`` with the tree as nested dicts of tensors."""
    path, meta = _open(ckpt_dir, step)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_numpy(flat, device), meta
