"""AST linter for the PyTorch hazards of this port.

The port of ``repro/analysis/lint.py``, whose four JAX rules each become
the torch hazard of the same shape:

- ``TH001`` compile-in-hot-path (JH001): ``torch.compile(...)``,
  ``torch.jit.script(...)`` or ``torch.jit.trace(...)`` immediately
  invoked, built inside a loop, or built inside a per-step/per-request
  function body without being cached on an attribute/subscript — every
  call compiles (or traces) again.  Factories (``make_*``/``build_*``/
  ``jit_*``) and cached-assignment idioms (``self._fn = torch.compile(...)``,
  ``cache[k] = torch.compile(...)``, ``return torch.compile(...)``) are
  exempt, as in the reference.
- ``TH002`` wall-clock-in-virtual-clock-module (JH002, unchanged):
  ``time.time``/``time.sleep`` in modules that run on a virtual clock
  (``sim/``, ``serve/scheduler.py``) — a single wall-clock read
  desynchronizes a deterministic replay.  ``time.perf_counter`` is allowed:
  the serving scheduler *measures* op durations to advance its virtual
  clock.
- ``TH003`` assert-on-tensor (JH003): Python ``assert`` over a tensor
  expression (one naming ``torch``, or calling ``.item()``, ``.all()`` or
  ``.any()``) — in eager mode the test copies a device value to the host,
  a synchronisation on every call, and ``python -O`` drops the check.
- ``TH004`` unknown-axis (JH004): string axis names in the spec tuples
  the sharding code reads.  A mesh-axis spec (the ``spec`` of
  ``placements(spec, mesh)`` and ``NamedSharding(mesh, spec)``) may only
  name {pod, data, model}; a logical-axis tuple (the axes of
  ``pspec(axes, ...)``, ``constrain(x, axes)`` and ``gather_leaf(x, axes)``)
  only the logical axes the rules define (``dist.sharding.sharding_rules``'
  keys).  Either typo silently replicates.

Intentional sites live in the committed allowlist (``lint_allowlist.txt``
next to this module): one line per site, ``RULE  path-suffix  qualname  #
justification``.  Run as::

    python -m repro_torch.analysis.lint src/repro_torch

Exit status 1 when any unallowlisted finding remains.
"""
from __future__ import annotations

import argparse
import ast
import sys
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import FrozenSet, Iterable, List, Optional, Sequence, Tuple

MESH_AXIS_VOCAB = frozenset({"pod", "data", "model"})

# modules that must never read the wall clock (deterministic replay)
VIRTUAL_CLOCK_PARTS = ("sim",)
VIRTUAL_CLOCK_FILES = ("serve/scheduler.py",)

# function-name markers for per-step/per-request hot paths
HOT_MARKERS = ("step", "generate", "admit", "pump", "decode", "prefill",
               "serve", "handle_", "retire", "tick")
# factory prefixes: functions that exist to build a compiled callable once
FACTORY_PREFIXES = ("make_", "build_", "_make_", "_build_", "jit_")

# tensor methods whose value a Python ``assert`` must bring to the host
SYNC_METHODS = ("item", "all", "any")

# call name -> (index of the axes argument, "mesh" or "logical" vocabulary)
AXIS_ARGS = {"placements": (0, "mesh"), "NamedSharding": (1, "mesh"),
             "pspec": (0, "logical"), "constrain": (1, "logical"),
             "gather_leaf": (1, "logical")}


@dataclass(frozen=True)
class LintFinding:
    path: str        # posix path as given on the command line
    line: int
    col: int
    rule: str
    message: str
    qualname: str    # innermost enclosing function ('' at module level)

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message}")


# -- allowlist --------------------------------------------------------------


@dataclass(frozen=True)
class AllowEntry:
    rule: str
    path_suffix: str
    qualname: str
    justification: str


def load_allowlist(path: Optional[Path] = None) -> List[AllowEntry]:
    if path is None:
        path = Path(__file__).with_name("lint_allowlist.txt")
    if not path.exists():
        return []
    out = []
    for raw in path.read_text().splitlines():
        line, _, comment = raw.partition("#")
        fields = line.split()
        if not fields:
            continue
        if len(fields) != 3:
            raise ValueError(
                f"{path}: malformed allowlist line {raw!r} "
                f"(want: RULE path-suffix qualname  # justification)")
        out.append(AllowEntry(fields[0], fields[1], fields[2],
                              comment.strip()))
    return out


def _allowed(f: LintFinding, allow: Sequence[AllowEntry]) -> bool:
    p = Path(f.path).as_posix()
    return any(
        a.rule == f.rule and p.endswith(a.path_suffix)
        and a.qualname == f.qualname
        for a in allow
    )


# -- AST helpers ------------------------------------------------------------


def _attach_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._lint_parent = node  # type: ignore[attr-defined]


def _parents(node: ast.AST) -> Iterable[ast.AST]:
    cur = getattr(node, "_lint_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_lint_parent", None)


def _enclosing_funcs(node: ast.AST) -> List[ast.AST]:
    return [p for p in _parents(node)
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _qualname(node: ast.AST) -> str:
    names = [f.name for f in _enclosing_funcs(node)]
    for p in _parents(node):
        if isinstance(p, ast.ClassDef):
            names.append(p.name)
            break
    return ".".join(reversed(names))


def _dotted(node: ast.AST) -> str:
    """``torch.jit.script`` for the attribute chain of a call's function."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


COMPILERS = ("torch.compile", "torch.jit.script", "torch.jit.trace")


def _is_compile(call: ast.Call) -> bool:
    return _dotted(call.func) in COMPILERS


def _string_leaves(node: ast.AST) -> Iterable[Tuple[ast.AST, str]]:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            yield n, n.value


@lru_cache(maxsize=1)
def logical_axis_vocab() -> FrozenSet[str]:
    """The logical axes the sharding rules define (their keys, which do not
    depend on the config or the mesh)."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import sharding_rules
    from repro_torch.launch.mesh import AbstractMesh

    return frozenset(sharding_rules(get_config("llama3-8b"),
                                    AbstractMesh((1, 1), ("data", "model"))))


# -- rules ------------------------------------------------------------------


def _check_compile(tree: ast.AST, path: str) -> List[LintFinding]:
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _is_compile(node)):
            continue
        parent = getattr(node, "_lint_parent", None)
        qn = _qualname(node)
        what = _dotted(node.func)

        # torch.compile(f)(x): compiled object thrown away after one call
        if isinstance(parent, ast.Call) and parent.func is node:
            out.append(LintFinding(
                path, node.lineno, node.col_offset, "TH001",
                f"{what}(...) immediately invoked — the compiled callable "
                "is discarded and every call compiles again", qn))
            continue

        # cached-assignment idioms are safe anywhere
        if isinstance(parent, ast.Return):
            continue
        if isinstance(parent, ast.Assign) and any(
                isinstance(t, (ast.Attribute, ast.Subscript))
                for t in parent.targets):
            continue

        funcs = _enclosing_funcs(node)
        in_loop = any(
            isinstance(p, (ast.For, ast.While, ast.AsyncFor))
            for p in _parents(node)
        )
        innermost = funcs[0].name if funcs else ""
        is_factory = innermost.startswith(FACTORY_PREFIXES)
        is_hot = (not is_factory and any(
            m in innermost.lower() for m in HOT_MARKERS))
        if in_loop:
            out.append(LintFinding(
                path, node.lineno, node.col_offset, "TH001",
                f"{what}(...) inside a loop without an attribute/subscript "
                "cache — compiles every iteration", qn))
        elif is_hot:
            out.append(LintFinding(
                path, node.lineno, node.col_offset, "TH001",
                f"{what}(...) in per-step/per-request function "
                f"{innermost!r} without an attribute/subscript cache — "
                f"compiles on every call", qn))
    return out


def _is_virtual_clock_module(path: str) -> bool:
    p = Path(path).as_posix()
    if any(p.endswith(f) for f in VIRTUAL_CLOCK_FILES):
        return True
    return any(part in VIRTUAL_CLOCK_PARTS for part in Path(p).parts)


def _check_wallclock(tree: ast.AST, path: str) -> List[LintFinding]:
    if not _is_virtual_clock_module(path):
        return []
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and node.attr in ("time", "sleep")
                and isinstance(node.value, ast.Name)
                and node.value.id == "time"):
            out.append(LintFinding(
                path, node.lineno, node.col_offset, "TH002",
                f"time.{node.attr} in a virtual-clock module — wall-clock "
                f"reads desynchronize deterministic replay "
                f"(time.perf_counter for measured durations is fine)",
                _qualname(node)))
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            bad = [a.name for a in node.names
                   if a.name in ("time", "sleep")]
            if bad:
                out.append(LintFinding(
                    path, node.lineno, node.col_offset, "TH002",
                    f"from time import {', '.join(bad)} in a virtual-clock "
                    f"module", _qualname(node)))
    return out


def _check_tensor_assert(tree: ast.AST, path: str) -> List[LintFinding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assert):
            continue
        for n in ast.walk(node.test):
            if ((isinstance(n, ast.Name) and n.id == "torch")
                    or (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                        and n.func.attr in SYNC_METHODS)):
                out.append(LintFinding(
                    path, node.lineno, node.col_offset, "TH003",
                    "assert over a tensor expression — the test waits for the "
                    "device on every call (and -O drops it); check outside the "
                    "hot path and raise", _qualname(node)))
                break
    return out


def _check_axes(tree: ast.AST, path: str) -> List[LintFinding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = (f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else None)
        if name not in AXIS_ARGS:
            continue
        index, kind = AXIS_ARGS[name]
        if len(node.args) <= index:
            continue
        vocab = MESH_AXIS_VOCAB if kind == "mesh" else logical_axis_vocab()
        for leaf, s in _string_leaves(node.args[index]):
            if s not in vocab:
                out.append(LintFinding(
                    path, leaf.lineno, leaf.col_offset, "TH004",
                    f"{kind} axis {s!r} passed to {name} is outside the "
                    f"{kind}-axis vocabulary — an unknown axis silently "
                    f"replicates", _qualname(node)))
    return out


RULES = (_check_compile, _check_wallclock, _check_tensor_assert, _check_axes)


# -- running the rules -------------------------------------------------------


def lint_file(path: Path, display: Optional[str] = None) -> List[LintFinding]:
    src = path.read_text()
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [LintFinding(display or str(path), e.lineno or 0, 0,
                            "TH000", f"syntax error: {e.msg}", "")]
    _attach_parents(tree)
    out: List[LintFinding] = []
    for rule in RULES:
        out.extend(rule(tree, display or str(path)))
    return out


def lint_paths(paths: Sequence[str],
               allowlist: Optional[Sequence[AllowEntry]] = None,
               ) -> Tuple[List[LintFinding], List[LintFinding]]:
    """Lint files/trees; returns (findings, suppressed-by-allowlist)."""
    allow = load_allowlist() if allowlist is None else list(allowlist)
    files: List[Path] = []
    for p in paths:
        pp = Path(p)
        files.extend(sorted(pp.rglob("*.py")) if pp.is_dir() else [pp])
    findings: List[LintFinding] = []
    suppressed: List[LintFinding] = []
    for f in files:
        for hit in lint_file(f, display=f.as_posix()):
            (suppressed if _allowed(hit, allow) else findings).append(hit)
    return findings, suppressed


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="PyTorch-hazard linter (compiles in hot paths, wall-clock "
                    "in virtual-clock modules, asserts on tensors, unknown "
                    "sharding axes)")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--allowlist", type=Path, default=None,
                    help="override the committed allowlist file")
    args = ap.parse_args(argv)
    allow = (load_allowlist(args.allowlist) if args.allowlist
             else load_allowlist())
    findings, suppressed = lint_paths(args.paths, allowlist=allow)
    for f in findings:
        print(f)
    if suppressed:
        print(f"({len(suppressed)} allowlisted finding(s) suppressed)",
              file=sys.stderr)
    if findings:
        print(f"{len(findings)} finding(s)", file=sys.stderr)
        return 1
    print(f"lint clean ({len(suppressed)} allowlisted)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
