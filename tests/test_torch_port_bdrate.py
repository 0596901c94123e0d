"""Port parity, utils/bdrate.py (a numpy copy of the JAX package's
module) against learned_pmctf_tpu.utils.bdrate: BD-rate and BD-PSNR on
seeded RD curves (cubic fits at 4 and more points, quadratic at 3), the
errors it raises, and bd_rate_from_logs and the ``python -m`` entry on
the eval CLIs' JSON: the port CLI's against the JAX CLI's, the JAX CLI
driven with the port's codec as test_torch_port_eval.py drives it, so
the BD-rate between them is the parity measure of BASELINE.md (0 when
the two CLIs agree).

Tolerances: the port's functions give the JAX module's numbers to 1e-12
(the same numpy code); the two CLIs' BD-rate is within 1e-3 percent of
0 (their PSNRs agree to 1e-4 dB, their bits exactly).
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import test_pmctf_flex as jax_flex
from learned_pmctf_tpu.utils import bdrate as jax_bdrate
from learned_pmctf_tpu_torch.cli import flex
from learned_pmctf_tpu_torch.utils import bdrate
from test_torch_port_eval import SMALL_ARGS, PortCodecForJaxCli

EXACT = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def rd_curve(g, n, rate0, psnr0):
    """n points of a plausible RD curve: rates growing geometrically,
    PSNR growing with log-rate plus a little noise."""
    rate = rate0 * np.cumprod(g.uniform(1.3, 1.9, n))
    psnr = psnr0 + 4.5 * np.log2(rate / rate0) + g.normal(0, 0.2, n)
    return list(zip(rate.tolist(), psnr.tolist()))


@pytest.mark.parametrize("n", [3, 4, 6])
def test_bd_metrics_match_jax_on_seeded_curves(n):
    """Cubic (4 and 6 points) and quadratic (3 points) fits, both
    directions, shuffled point order."""
    g = np.random.default_rng(n)
    for _ in range(5):
        anchor = rd_curve(g, n, 0.05, 30.0)
        test = rd_curve(g, n, 0.045, 30.3)
        g.shuffle(test)
        for a, t in ((anchor, test), (test, anchor)):
            for name in ("bd_rate", "bd_psnr"):
                got, want = getattr(bdrate, name)(a, t), getattr(jax_bdrate, name)(a, t)
                assert abs(got - want) <= EXACT * max(1.0, abs(want)), (name, got, want)
        assert abs(bdrate.bd_rate(anchor, anchor)) < 1e-9


def test_bd_errors_match_jax():
    """Curves that do not overlap, too few points, a rate <= 0: the same
    ValueError from both."""
    low = [(0.1, 30.0), (0.2, 32.0), (0.4, 34.0), (0.8, 36.0)]
    high = [(r, q + 20.0) for r, q in low]
    far = [(r * 100, q) for r, q in low]
    cases = [("bd_rate", low, high), ("bd_psnr", low, far), ("bd_rate", low[:2], low),
             ("bd_rate", [(0.0, 30.0)] + low[1:], low)]
    for name, a, t in cases:
        with pytest.raises(ValueError) as port_err:
            getattr(bdrate, name)(a, t)
        with pytest.raises(ValueError) as jax_err:
            getattr(jax_bdrate, name)(a, t)
        assert str(port_err.value) == str(jax_err.value)


def _per_q(out_json, q_list):
    logs = {}
    for q in q_list:
        with open(str(out_json).replace(".json", f"_qidx{q}.json")) as f:
            logs[q] = json.load(f)["synthetic_ds"]["synthetic"]
    return logs


def _entry(main, *paths):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main([str(p) for p in paths])
    return json.loads(buf.getvalue())


def test_bd_rate_from_the_port_cli_against_the_jax_cli(tmp_path, monkeypatch):
    """A GOP-2 at four rate points through the port CLI and through the
    JAX CLI on the port's codec: bd_rate_from_logs and the ``-m`` entry
    on their summaries give the JAX module's numbers, and a BD-rate of 0
    between the two CLIs."""
    args = SMALL_ARGS + ["--synthetic", "2", "--force_intra_period", "2",
                         "--q_index_num", "4"]
    q_list = [0, 6, 12, 20]
    port_out, jax_out = tmp_path / "port" / "out.json", tmp_path / "jax" / "out.json"
    flex.main(args + ["--output_path", str(port_out), "--device", "cpu"])
    with flex.build_codec(flex.parse_args(args + ["--device", "cpu"])) as codec:
        monkeypatch.setattr(jax_flex, "build_codec", lambda a: PortCodecForJaxCli(codec))
        jax_flex.main(args + ["--output_path", str(jax_out)])
    port_logs, jax_logs = _per_q(port_out, q_list), _per_q(jax_out, q_list)
    assert len({log["ave_all_frame_psnr"] for log in port_logs.values()}) == 4
    for a, t in ((jax_logs, port_logs), (port_logs, jax_logs)):
        got, want = bdrate.bd_rate_from_logs(a, t), jax_bdrate.bd_rate_from_logs(a, t)
        assert abs(got - want) <= EXACT * max(1.0, abs(want))
        assert abs(got) < 1e-3, got
    summaries = [str(p).replace(".json", "_summary.json") for p in (jax_out, port_out)]
    port_entry, jax_entry = _entry(bdrate.main, *summaries), _entry(jax_bdrate.main, *summaries)
    assert port_entry == jax_entry and port_entry["anchor_points"] == 4
    assert abs(port_entry["bd_rate_pct"]) < 1e-3
