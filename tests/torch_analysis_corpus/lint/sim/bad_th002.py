"""Corpus: wall-clock reads in a virtual-clock (sim/) module."""
import time
from time import sleep  # noqa: F401  (flagged: from-import of sleep)


def advance(events):
    now = time.time()  # flagged: wall clock in a deterministic replay
    time.sleep(0.01)   # flagged
    return [e for e in events if e.t <= now]
