"""Bjøntegaard-delta metrics (BD-rate / BD-PSNR).

A copy of learned_pmctf_tpu/utils/bdrate.py (numpy only), so that the
port imports nothing of the JAX package. It is the parity measure of
BASELINE.md and docs/bdrate_artifact.json: the BD-rate between two eval
CLIs' RD curves (the port's cli/flex.py against the JAX
test_pmctf_flex.py, or a checkpoint against the reference). The
standard VCEG-M33 formulation: fit PSNR <-> log10(rate) with a cubic
polynomial per curve and integrate the gap over the overlapping quality
interval.

Usage with the eval CLIs' JSON outputs:
    bd_rate(anchor_rd, test_rd)  -> percent rate change at equal quality
    bd_psnr(anchor_rd, test_rd)  -> dB change at equal rate
where each rd is a sequence of (bpp_or_bitrate, psnr) points (>= 4 for
a cubic fit; 3 points fall back to quadratic).

    python -m learned_pmctf_tpu_torch.utils.bdrate anchor_summary.json \
        test_summary.json
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _fit_and_integrate(x, y, lo, hi):
    """Integral of a polyfit of y(x) over [lo, hi]."""
    order = 3 if len(x) >= 4 else 2
    p = np.polyfit(x, y, order)
    P = np.polyint(p)
    return np.polyval(P, hi) - np.polyval(P, lo)


def _prep(rd: Sequence[Tuple[float, float]]):
    rd = sorted((float(r), float(q)) for r, q in rd)
    rate = np.asarray([r for r, _ in rd])
    qual = np.asarray([q for _, q in rd])
    if len(rate) < 3:
        raise ValueError(f"need >=3 RD points, got {len(rate)}")
    if np.any(rate <= 0):
        raise ValueError("rates must be positive")
    return np.log10(rate), qual


def bd_rate(anchor: Sequence[Tuple[float, float]],
            test: Sequence[Tuple[float, float]]) -> float:
    """Average rate difference of `test` vs `anchor` at equal quality, in
    percent (negative = test needs less rate). Rates may be bpp or kbps
    (scale cancels)."""
    lr_a, q_a = _prep(anchor)
    lr_t, q_t = _prep(test)
    lo, hi = max(q_a.min(), q_t.min()), min(q_a.max(), q_t.max())
    if hi <= lo:
        raise ValueError("RD curves do not overlap in quality")
    # integrate log-rate as a function of quality
    int_a = _fit_and_integrate(q_a, lr_a, lo, hi)
    int_t = _fit_and_integrate(q_t, lr_t, lo, hi)
    avg_diff = (int_t - int_a) / (hi - lo)
    return float((10.0 ** avg_diff - 1.0) * 100.0)


def bd_psnr(anchor: Sequence[Tuple[float, float]],
            test: Sequence[Tuple[float, float]]) -> float:
    """Average quality difference of `test` vs `anchor` at equal rate, in
    dB (positive = test is better)."""
    lr_a, q_a = _prep(anchor)
    lr_t, q_t = _prep(test)
    lo, hi = max(lr_a.min(), lr_t.min()), min(lr_a.max(), lr_t.max())
    if hi <= lo:
        raise ValueError("RD curves do not overlap in rate")
    int_a = _fit_and_integrate(lr_a, q_a, lo, hi)
    int_t = _fit_and_integrate(lr_t, q_t, lo, hi)
    return float((int_t - int_a) / (hi - lo))


def bd_rate_from_logs(anchor_logs: dict, test_logs: dict,
                      rate_key: str = "ave_all_frame_bpp",
                      qual_key: str = "ave_all_frame_psnr") -> float:
    """BD-rate from two {q_index: generate_log_json(...)} dicts as the
    eval CLIs produce (cli/flex.py run_test/run_test_qbatch)."""
    a = [(log[rate_key], log[qual_key]) for log in anchor_logs.values()]
    t = [(log[rate_key], log[qual_key]) for log in test_logs.values()]
    return bd_rate(a, t)


def _summary_to_rd(path: str):
    import json

    with open(path) as f:
        s = json.load(f)
    return list(zip(map(float, s["bpp"]), map(float, s["psnr-yuv"])))


def main(argv):
    """CLI: BD-rate/BD-PSNR between two eval summary JSONs.

    python -m learned_pmctf_tpu_torch.utils.bdrate anchor_summary.json \
        test_summary.json
    (summaries as written by cli/flex.py, cli/ca.py and the JAX CLIs)
    """
    import json

    anchor, test = _summary_to_rd(argv[0]), _summary_to_rd(argv[1])
    print(json.dumps({
        "bd_rate_pct": round(bd_rate(anchor, test), 4),
        "bd_psnr_db": round(bd_psnr(anchor, test), 4),
        "anchor_points": len(anchor), "test_points": len(test),
    }))


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
