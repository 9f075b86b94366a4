"""The comparisons that decide ``correct``: gaps between the program's
readings and the reference's, each a number held against its limit."""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Tuple


def norms(tensors: dict) -> dict:
    """{key: ‖tensor‖} read back in one transfer."""
    import torch

    keys = list(tensors)
    vals = torch.stack([tensors[k].float().norm() for k in keys]).tolist()
    return dict(zip(keys, vals))


def first_moment(opt, p):
    """Adam's first moment of p after its first step, (1 − β1)·g; zeros
    where the optimizer holds none (a step that did not run)."""
    import torch

    m = opt.state.get(p, {}).get("exp_avg")
    return torch.zeros_like(p) if m is None else m


def rel_gap(got: float, ref: float) -> float:
    return abs(got - ref) / max(abs(ref), 1e-30)


def loss_gap(got: Iterable[float], ref: Iterable[float]) -> float:
    """The largest relative gap of the steps' losses."""
    return max(rel_gap(g, r) for g, r in zip(got, ref))


def leaf_gap(got: Dict[str, float], ref: Dict[str, float],
             keep: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger → (gap, leaf)."""
    keys = sorted(keep if keep is not None else ref)
    med = statistics.median(ref[k] for k in keys)
    gaps = {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def moving_leaves(grad_norms: List[Dict[str, float]]) -> List[str]:
    """The leaves that a step's gradient moves: the largest of each leaf's
    reference gradient norms over the steps is at least a thousandth of
    the median leaf's. The others (a gradient that is nought to rounding)
    move under Adam by round-off alone."""
    top = {k: max(g[k] for g in grad_norms) for k in grad_norms[0]}
    med = statistics.median(top.values())
    return [k for k, v in top.items() if v >= 1e-3 * med]


def all_within(checks: List[Tuple[str, float, float]]) -> bool:
    return all(v == v and v <= lim for _, v, lim in checks)


def training_checks(losses, grad1: Dict[str, float], change: Dict[str, float],
                    ref: dict, limits: dict):
    """A training cell's checks and readings: the steps' loss gap, the
    worst leaf's first-gradient gap and the worst moving leaf's change
    gap (each against its limit; a limit left out of ``limits`` is not
    compared), with the per-step gaps, the median leaf's change gap and
    the worst leaves' names as readings."""
    keep = moving_leaves(ref["grad_norms"])
    gg, g_leaf = leaf_gap(grad1, ref["grad_norms"][0])
    dg, d_leaf = leaf_gap(change, ref["change_norms"], keep)
    med = statistics.median(rel_gap(change[k], ref["change_norms"][k])
                            for k in keep)
    g_med = statistics.median(rel_gap(grad1[k], ref["grad_norms"][0][k])
                              for k in grad1 if ref["grad_norms"][0][k] > 0)
    values = {"loss_gap": loss_gap(losses, ref["losses"]),
              "loss1_gap": rel_gap(losses[0], ref["losses"][0]),
              "grad_gap": gg, "grad_median_gap": g_med, "change_gap": dg,
              "change_median_gap": med}
    checks = [(k, values[k], limits[k]) for k in values if k in limits]
    readings = {"values": values, "losses": list(losses),
                "ref_losses": ref["losses"],
                "loss_gaps": [rel_gap(a, b) for a, b in
                              zip(losses, ref["losses"])],
                "grad_worst": g_leaf, "change_worst": d_leaf,
                "moving_leaves": len(keep), "leaves": len(change)}
    return checks, readings
