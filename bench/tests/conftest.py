import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA H100 (CUDA); skipped where none is present")


@pytest.fixture
def chip():
    """Skips the test where there is no CUDA device (decided here, when the
    test runs, never while a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark's cells run on an H100)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _shared_process(monkeypatch):
    """In-process runs share the test process, into which other tests may
    have loaded JAX: the foreign-module check is the subprocess test's."""
    from bench import harness

    monkeypatch.setattr(harness, "foreign_modules", lambda: [])
