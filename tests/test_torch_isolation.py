"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU fallback."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def test_every_module_imports_without_jax_or_repro():
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(ROOT / 'src')!r})
sys.modules['jax'] = None  # any import of jax now raises ImportError
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]
assert not bad, bad
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    for mod in _imports(path):
        assert mod.split(".")[0] not in FORBIDDEN, f"{path}: imports {mod}"


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    from repro_torch.checkpoint.ckpt import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ContinuousBatchingEngine, ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3-8b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(cfg, {}, lanes=1, n_pages=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, {}, batch=1, capacity=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({})


def test_chip_smoke_refuses_to_run_without_a_card():
    """With no visible card the smoke test exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
