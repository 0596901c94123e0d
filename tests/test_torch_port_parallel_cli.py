"""Port parity, the data-parallel entry points on the CPU:
cli/train_pmctf.py --data_parallel 2 (two gloo ranks it starts itself)
against --data_parallel 0 (one process) on the same seed and PNG set,
the two side by side (cli/flex.py --shard_q is in
test_torch_port_parallel_flex.py).

Tolerances: the checkpoints as dp_equiv_script.py holds JAX's sharded
step (parameters rtol 5e-4, atol 1.5e-4; the AdamW first moments, which
are the reduced gradients, rel 1e-4 of the largest) and the logged losses
rel 1e-5 (after the log's four decimals). Each rank runs two threads.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from test_torch_port_data import write_vimeo_pngs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P_RTOL, P_ATOL, LOSS_RTOL = 5e-4, 1.5e-4, 1e-5


def _start(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, *args], cwd=cwd, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _finish(proc, timeout=600):
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-5000:]
    return out


def _logged(path, key):
    vals = [float(v) for v in re.findall(rf"{key} (\S+)", path.read_text())]
    assert vals and all(np.isfinite(vals))
    return vals


def test_train_cli_data_parallel_matches_one_process(tmp_path):
    """One GOP-2 step (curriculum stage 1, part All; the MV rate terms
    logged with their noise) at batch 2: --data_parallel 2 (a row a rank)
    against --data_parallel 0. Rank 0 alone writes: one log and the
    checkpoint, nothing else."""
    data = tmp_path / "vimeo"
    write_vimeo_pngs(str(data), sequences=2, frames=8, h=64, w=72)
    (tmp_path / "one.json").write_text(json.dumps({
        "total_epochs": 1, "train_lambda": [1, 27], "num_stages": 10,
        "lr": [1e-5], "parts": ["All"], "num_frames": [2],
        "frame_interval": [1], "num_epochs": [1]}))
    runs = {}
    for name, n in (("one", "0"), ("dp", "2")):
        cwd = tmp_path / name
        cwd.mkdir()
        runs[name] = _start(["-m", "learned_pmctf_tpu_torch.cli.train_pmctf",
                             "-d", str(data), "--batch-size", "2", "--patchsize", "64", "64",
                             "--steps_per_epoch", "1", "--log_every", "1", "--device", "cpu",
                             "--warp_mode", "exact", "--num-workers", "1", "--fix_q", "10",
                             "--config", str(tmp_path / "one.json"), "--data_parallel", n],
                            cwd)
    outs = {name: _finish(proc) for name, proc in runs.items()}
    assert "data parallel: 2 ranks of 1 rows (gloo)" in outs["dp"]
    exp = {name: tmp_path / name / "experiments" / "pmctf_BS2" for name in runs}
    for name in runs:  # rank 0 alone wrote: one log, one checkpoint
        assert [p.name for p in (tmp_path / name).iterdir()] == ["experiments"]
        files = sorted(p.name for p in exp[name].iterdir())
        assert len(files) == 2 and files[0] == "state_epoch0", files
    logs = {name: next(exp[name].glob("train_*.log")) for name in runs}
    for key in (" rd", "mse", "bppH", "bppMV"):
        one, dp = _logged(logs["one"], key), _logged(logs["dp"], key)
        assert len(one) == len(dp) == 1
        np.testing.assert_allclose(dp, one, rtol=LOSS_RTOL, atol=1e-4, err_msg=key)
    assert _logged(logs["dp"], "bppMV")[0] > 0
    want, got = (torch.load(exp[name] / "state_epoch0" / "params.pt") for name in runs)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=P_RTOL, atol=P_ATOL,
                                   err_msg=k)
    opt = {name: torch.load(exp[name] / "state_epoch0" / "opt_state.pt") for name in runs}
    assert opt["dp"]["count"] == opt["one"]["count"] == 1
    moments = [float(st["exp_avg"].abs().max()) for st in opt["dp"]["adamw"]["state"].values()]
    assert max(moments) > 0
    for a, b in zip(opt["dp"]["adamw"]["state"].values(), opt["one"]["adamw"]["state"].values()):
        np.testing.assert_allclose(a["exp_avg"].numpy(), b["exp_avg"].numpy(), rtol=1e-4,
                                   atol=1e-4 * max(moments))
