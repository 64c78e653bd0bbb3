"""Corpus: every TH001 compile-in-hot-path shape the linter must flag."""
import torch


def run_immediate(f, x):
    # compiled callable discarded after one call
    return torch.compile(f)(x)


def build_all(fns, example):
    out = []
    for f in fns:
        g = torch.jit.trace(f, example)  # plain-name bind inside a loop: traces each time
        out.append(g)
    return out


def decode_step(f, x):
    g = torch.jit.script(f)  # per-step function body, no attribute/subscript cache
    return g(x)


class Engine:
    def __init__(self, f):
        self._fn = torch.compile(f)  # cached on an attribute: not flagged

    def make_step(self, f):
        return torch.compile(f)  # a factory's return: not flagged
