"""The comparison that decides ``correct``.

Each GOP output the harness kept (the window's GOP of the sampled
distinct index, and the traced GOP) is held against the plain
reference's estimate of the same frames with the same weights:

- ``bits_gap``: the largest relative gap of a frame's rate (``bit_H``,
  ``bit_ME``, ``bit_L``) from the reference's, |p - r| / max(|r|, 1);
- ``plane_rmse``: the largest root-mean-square difference of a frame's
  decoded luma or chroma planes from the reference's, in 8-bit levels.

A number that is not finite, or a frame or rate that is missing, reads
infinite. The cell's limits file says which numbers it compares and
their limits; ``correct`` holds when every compared number of every kept
output is at most its limit.
"""

from __future__ import annotations

import math
from typing import Dict, List

NUMBERS = ("bits_gap", "plane_rmse")


def gaps(out: Dict, expect: Dict) -> Dict[str, float]:
    """The numbers of one output against the reference's."""
    bits = 0.0
    for fi, rates in expect["bits"].items():
        got = out["bits"].get(fi, {})
        for key, r in rates.items():
            p = float(got[key]) if key in got else math.inf
            bits = max(bits, abs(p - r) / max(abs(r), 1.0) if math.isfinite(p) else math.inf)
    rmse = 0.0
    for plane in ("luma", "chroma"):
        if len(out[plane]) != len(expect[plane]):
            return {"bits_gap": bits, "plane_rmse": math.inf}
        for p, r in zip(out[plane], expect[plane]):
            if p.shape != r.shape:
                return {"bits_gap": bits, "plane_rmse": math.inf}
            d = (p.double() - r.to(p.device).double()).pow(2).mean().sqrt().item()
            rmse = max(rmse, d if math.isfinite(d) else math.inf)
    return {"bits_gap": bits, "plane_rmse": rmse}


def compare(outputs: List[Dict], expect: Dict, limits: Dict) -> Dict:
    """{"correct", "numbers": {name: {"value", "limit"}} (the largest over
    the outputs), "per_output": [{"ok", name: value}]}."""
    compared = [k for k in NUMBERS if k in limits]
    if not compared:
        raise ValueError("the limits file compares no number")
    per_output = []
    for out in outputs:
        g = gaps(out, expect)
        per_output.append({"ok": all(g[k] <= limits[k] for k in compared),
                           **{k: g[k] for k in compared}})
    numbers = {}
    for k in compared:
        v = max((o[k] for o in per_output), default=math.inf)
        numbers[k] = {"value": v if math.isfinite(v) else str(v), "limit": limits[k]}
    return {"correct": bool(per_output) and all(o["ok"] for o in per_output),
            "numbers": numbers, "per_output": per_output}

