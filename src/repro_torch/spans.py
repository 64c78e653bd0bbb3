"""Spans: named, nested intervals of host time at the port's layer
boundaries (the training step's forward, backward and optimizer).

``span(name)`` marks a block.  Recording is off by default: ``span`` then
reads one module global and returns one shared no-op context manager, so
a step allocates nothing for it, takes no clock and never touches the
device.  Inside ``with recording() as spans:`` every span entered (on any
thread) appends a ``Span`` to the list ``spans``: its name, its id, its
parent's id (the innermost span open on the same thread, else ``None``),
the number of the enclosing ``train.step`` (counted from 0 within the
recording; the identifier all of one step's spans share, ``None`` outside
a step), and its start and end.

Start and end come from ``time.time_ns()``, the clock of the events of
``torch.profiler`` (``start_ns()`` of its raw events): a span and a
profile taken over the same steps share one timeline, so a device
operation can be given to the span that was open when its launch was
issued.  Spans read no device value, so they never synchronise; they are
kept in memory, in the list ``recording`` yields, and never written out.
"""
from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Iterator, List, Optional

STEP = "train.step"


@dataclass
class Span:
    name: str
    id: int
    parent: Optional[int]
    step: Optional[int]
    start_ns: int
    end_ns: int = 0


_OFF = nullcontext()  # the span of every unrecorded block


class _Recording:
    """One ``recording()`` block's list and counters."""

    def __init__(self):
        self.spans: List[Span] = []
        self.ids = itertools.count()
        self.steps = itertools.count()


_active: Optional[_Recording] = None  # the recording under way, if any
_open = threading.local()  # .stack: the spans this thread has open, innermost last


class _On:
    __slots__ = ("rec", "name", "span")

    def __init__(self, rec: _Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        outer = stack[-1] if stack else None
        step = next(self.rec.steps) if self.name == STEP else (outer.step if outer else None)
        self.span = Span(self.name, next(self.rec.ids), outer.id if outer else None, step,
                         time.time_ns())
        stack.append(self.span)
        return self.span

    def __exit__(self, *exc):
        self.span.end_ns = time.time_ns()
        _open.stack.pop()
        self.rec.spans.append(self.span)
        return False


def span(name: str):
    """A context manager marking a block as the span ``name``."""
    rec = _active
    if rec is None:
        return _OFF
    return _On(rec, name)


@contextmanager
def recording() -> Iterator[List[Span]]:
    """Records every span entered inside the block into the list it
    yields, each appended when it ends (children before their parent)."""
    global _active
    outer, _active = _active, _Recording()
    try:
        yield _active.spans
    finally:
        _active = outer
