"""The comparison that decides ``correct``: the program's first steps
against the plain reference's, number by number, each against its limit
from the cell's file.

* ``loss_gap``: the largest relative gap of a step's loss,
  ``|L_program - L_reference| / |L_reference|``, over the checked steps.
* ``grad_norm_gap``: by the worst leaf, the gap between the program's and
  the reference's norm of the first (clipped) gradient, as the optimizer
  got it, over the larger of the reference's norm of that leaf and of the
  median leaf.
* ``change_norm_gap``: the same for the norm of each leaf's change over the
  checked steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (gradients that are nought but for
  rounding, as a key's bias under softmax, move under Adam by round-off
  alone).
* ``grad_norm_gap_median``, ``change_norm_gap_median``: the median leaf's
  gap, where one leaf's gap is the noise of a sum that cancels.
* ``nonfinite_losses``: losses of the checked and the timed steps that are
  not finite.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict

QUIET = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> list:
    """Each leaf's gap; a gap that is not finite (a NaN norm) is inf."""
    med = statistics.median(ref[p] for p in keep)
    gaps = [abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30) for p in keep]
    return [g if math.isfinite(g) else math.inf for g in gaps]


def numbers(program: dict, reference: dict) -> Dict[str, float]:
    """``program`` and ``reference``: ``loss`` (a list), ``grad_norm`` and
    ``change_norm`` (``{path: norm}``); ``program`` also ``nonfinite``."""
    if set(program["grad_norm"]) != set(reference["grad_norm"]):
        raise ValueError("the program's leaves are not the reference's")
    losses = list(zip(program["loss"], reference["loss"]))
    loss_gap = max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf for p, r in losses)
    leaves = sorted(reference["grad_norm"])
    ref_g = reference["grad_norm"]
    med = statistics.median(ref_g[p] for p in leaves)
    moving = [p for p in leaves if ref_g[p] >= QUIET * med]
    grad = _gaps(program["grad_norm"], ref_g, leaves)
    change = _gaps(program["change_norm"], reference["change_norm"], moving)
    return {
        "loss_gap": loss_gap,
        "grad_norm_gap": max(grad),
        "grad_norm_gap_median": statistics.median(grad),
        "change_norm_gap": max(change),
        "change_norm_gap_median": statistics.median(change),
        "nonfinite_losses": float(program["nonfinite"]),
    }


def worst_leaves(program: dict, reference: dict) -> Dict[str, str]:
    """The leaf that sets each of the two norm gaps."""
    ref_g = reference["grad_norm"]
    med = statistics.median(ref_g.values())
    out = {}
    for key, keep in (("grad_norm", list(ref_g)),
                      ("change_norm", [p for p in ref_g if ref_g[p] >= QUIET * med])):
        ref = reference[key]
        m = statistics.median(ref[p] for p in keep)
        out[key] = max(keep, key=lambda p: abs(program[key][p] - ref[p]) / max(ref[p], m, 1e-30))
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: correct when every number
    is at most its limit (a NaN never is)."""
    missing = set(limits) - set(values)
    if missing:
        raise ValueError(f"no reading for the limits {sorted(missing)}")
    table = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
