"""Deterministic synthetic LM data pipeline.

The port of ``repro/data/pipeline.py``.  Host batches are made with the
reference's numpy code, so for a given (seed, step) they are bit-identical
to the reference's; restart-safe (the cursor is checkpointed).  A
background thread keeps ``prefetch`` batches ready so host data work
overlaps device compute.  ``next()`` returns the batch on ``device``:
token and label ids as int64, an encoder-decoder batch's ``frames`` and a
vision batch's ``patch_embeds`` as the reference's fp32 (the models cast
them to ``cfg.dtype``).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import DEC_RATIO


@dataclass
class DataCursor:
    seed: int
    step: int


def _skewed_tokens(rng, shape, V):
    """Zipf-ish unigram skew (p(i) ∝ i^{-2/3}): a learnable distribution so
    smoke-training loss actually decreases below the uniform entropy."""
    u = rng.random(shape)
    return np.minimum((u ** 3 * V), V - 1).astype(np.int32)


def make_host_batch(cfg: ModelConfig, batch: int, seq: int, seed: int,
                    step: int) -> Dict[str, np.ndarray]:
    """The reference's host batch for (seed, step), as numpy arrays, drawn
    in the reference's order: an encoder-decoder batch's decoder tokens
    (``max(seq // DEC_RATIO, 8)``) then its fp32 frames ``(batch, seq,
    d_model)``; a vision batch's text tokens then its fp32 patches
    (``max(seq // 4, 4)`` positions, the rest text); else tokens alone."""
    rng = np.random.default_rng((seed << 20) ^ step)
    V = cfg.vocab_size

    def labels(toks):
        return np.roll(toks, -1, axis=1).astype(np.int32)

    if cfg.num_encoder_layers:
        toks = _skewed_tokens(rng, (batch, max(seq // DEC_RATIO, 8)), V)
        return {"frames": rng.standard_normal((batch, seq, cfg.d_model), dtype=np.float32),
                "tokens": toks, "labels": labels(toks)}
    if cfg.frontend == "vision":
        si = max(seq // 4, 4)
        toks = _skewed_tokens(rng, (batch, seq - si), V)
        return {"tokens": toks, "labels": labels(toks),
                "patch_embeds": rng.standard_normal((batch, si, cfg.d_model),
                                                    dtype=np.float32)}
    toks = _skewed_tokens(rng, (batch, seq), V)
    return {"tokens": toks, "labels": labels(toks)}


class SyntheticLMData:
    """Skewed-unigram synthetic tokens (deterministic per (seed, step))."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                 start_step: int = 0, device: DeviceLike = None, prefetch: int = 2):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.device = resolve_device(device)
        self.prefetch = max(prefetch, 1)
        self.cursor = DataCursor(seed=seed, step=start_step)
        self._start()

    def _start(self) -> None:
        """A producer thread for the current cursor, with its own queue and
        stop flag, so a restore never sees batches made for the old one."""
        self._q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._producer, args=(self._q, self._stop, self.cursor.seed,
                                         self.cursor.step), daemon=True)
        self._thread.start()

    def _producer(self, q: queue.Queue, stop: threading.Event, seed: int, step: int):
        while not stop.is_set():
            hb = make_host_batch(self.cfg, self.batch, self.seq, seed, step)
            while not stop.is_set():
                try:
                    q.put((step, hb), timeout=0.5)
                    step += 1
                    break
                except queue.Full:
                    continue

    def __next__(self) -> Dict[str, torch.Tensor]:
        step, hb = self._q.get()
        self.cursor.step = step + 1
        return {k: torch.from_numpy(v if v.dtype == np.float32 else v.astype(np.int64))
                .to(self.device) for k, v in hb.items()}

    def __iter__(self) -> Iterator:
        return self

    def state(self) -> dict:
        return {"seed": self.cursor.seed, "step": self.cursor.step}

    def restore(self, state: dict) -> None:
        self.close()
        self.cursor = DataCursor(seed=state["seed"], step=state["step"])
        self._start()

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
