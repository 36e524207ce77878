"""The numbers that decide ``correct``, each compared with its limit.

Every number is a gap between what the timed path produced and what the
plain reference gives for the same inputs, so that 0 is perfect agreement;
the limits of each cell sit in ``workloads/<cell>.json``.
"""

from __future__ import annotations

import math
from typing import Iterable, Mapping, Optional, Sequence

import torch

#: a leaf whose reference gradient is under this share of the median leaf's
#: moves by round-off alone (a bias under softmax, say) and is left out
GRAD_FLOOR = 1e-3


def rel_gap(p: float, r: float) -> float:
    if math.isnan(p) and math.isnan(r):
        return 0.0
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / max(abs(r), 1e-30)


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def leaf_gap(prog: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor],
             ref_grad_norms: Mapping[str, float]) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    relative to the larger of the reference leaf's norm and the median
    leaf's; leaves whose reference gradient is under ``GRAD_FLOOR`` of the
    median leaf's are left out."""
    med_grad = _median(list(ref_grad_norms.values()))
    ref_norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in ref}
    med = _median(list(ref_norms.values()))
    per = {}
    for k in ref:
        if ref_grad_norms[k] < GRAD_FLOOR * med_grad:
            continue
        p = float(torch.linalg.vector_norm(prog[k].double()))
        per[k] = abs(p - ref_norms[k]) / max(ref_norms[k], med, 1e-30) if math.isfinite(p) else math.inf
    return max(per.values()) if per else math.inf


def metrics_gap(results: Iterable[Mapping], ref: Mapping) -> float:
    """The largest relative gap of any metric at any cutoff, over every
    result dict (cutoff -> metric -> value) the window produced."""
    worst, seen = 0.0, 0
    for res in results:
        seen += 1
        if set(res) != set(ref):
            return math.inf
        for c, row in ref.items():
            for name, r in row.items():
                if name not in res[c]:
                    return math.inf
                worst = max(worst, rel_gap(float(res[c][name]), float(r)))
    return worst if seen else math.inf


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float], failed: int) -> bool:
    """True when every limited number is present, finite and within its
    limit, and nothing failed."""
    if failed:
        return False
    for name, limit in limits.items():
        v: Optional[float] = numbers.get(name)
        if v is None or not math.isfinite(v) or v > limit:
            return False
    return True
