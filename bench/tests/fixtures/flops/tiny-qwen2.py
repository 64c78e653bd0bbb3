"""The model-FLOP formula of qwen2-1.5b, for its test-sized configuration."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "flops_qwen2", Path(__file__).resolve().parents[3] / "flops" / "qwen2-1.5b.py")
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)
forward_flops = _mod.forward_flops
