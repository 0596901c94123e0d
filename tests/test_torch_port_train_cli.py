"""The training CLIs (cli/train_pmctf.py, cli/train_pwave.py) on the
CPU: one step or two of each on a temporary PNG dataset, at full width
(the trainers have no width flags), the pWave trainer's validation
pictures, and the resume arithmetic; --lossless in both (the lossless modules are held against
JAX in tests/test_torch_port_lossless.py, the YCoCg frames in
tests/test_torch_port_data.py).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np

from learned_pmctf_tpu_torch.training import curriculum
from test_torch_port_data import write_vimeo_pngs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- the training CLIs -------------------------------------------------------

def _cli(module, args, cwd):
    # two threads, as this module's own torch: the tier-1 run shares the
    # machine's cores among its workers
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=900)


def _losses(text, key):
    """The values a training log prints after `key` (a regex); all finite."""
    vals = [float(v) for v in re.findall(rf"{key} (\S+)", text)]
    assert vals and all(np.isfinite(vals)), text[-2000:]
    return vals


def test_resume_point_follows_the_curriculum():
    """--resume: the epoch after the checkpoint's, its stage and the epochs
    already done in it; --start_stage jumps to a stage's first epoch."""
    from argparse import Namespace
    from learned_pmctf_tpu_torch.cli.train_pmctf import resume_point
    cfg = curriculum.CurriculumConfig.from_json(
        os.path.join(ROOT, "configs", "train_mctf_gop16.json"))
    args = Namespace(start_stage=-1)
    assert resume_point(cfg, args, {"epoch": 0}) == (1, 1, 0)
    assert resume_point(cfg, args, {"epoch": 2}) == (3, 1, 2)
    assert resume_point(cfg, args, {"epoch": 23}) == (24, 7, 0)
    assert resume_point(cfg, Namespace(start_stage=7), {"epoch": 0}) == (19, 6, 0)


def test_train_clis_on_the_cpu(tmp_path):
    """train_pmctf one GOP-2 step (part All), its checkpoint, then
    train_pwave two steps and its best-loss checkpoint. Full width (the
    trainers have no width flags), 64x64 patches, batch 1."""
    data = tmp_path / "vimeo"
    write_vimeo_pngs(str(data), sequences=2, frames=8, h=64, w=72)
    (tmp_path / "one.json").write_text(json.dumps({
        "total_epochs": 1, "train_lambda": [1, 27], "num_stages": 10,
        "lr": [1e-5], "parts": ["All"], "num_frames": [2],
        "frame_interval": [1], "num_epochs": [1]}))
    first = _cli("learned_pmctf_tpu_torch.cli.train_pmctf",
                 ["-d", str(data), "--batch-size", "1", "--patchsize", "64", "64",
                  "--steps_per_epoch", "1", "--log_every", "1", "--device", "cpu",
                  "--warp_mode", "exact", "--num-workers", "1", "--fix_q", "10",
                  "--config", str(tmp_path / "one.json")], tmp_path)
    assert first.returncode == 0, first.stdout[-3000:] + first.stderr[-3000:]
    ck = tmp_path / "experiments" / "pmctf_BS1" / "state_epoch0"
    assert {p.name for p in ck.iterdir()} == {"params.pt", "opt_state.pt", "meta.json"}
    assert json.loads((ck / "meta.json").read_text()) == {
        "epoch": 0, "stage_num": 0, "quant_stage": False}
    assert "STAGE 1: part=All frames=2" in first.stdout
    _losses(first.stdout, " rd")

    pw = _cli("learned_pmctf_tpu_torch.cli.train_pwave",
              ["-d", str(data), "--epochs", "1", "--batch-size", "1",
               "--test-batch-size", "2", "--patch-size", "64", "64",
               "--steps_per_epoch", "2", "--device", "cpu", "-n", "1",
               "--experiments_root", str(tmp_path / "pw")], tmp_path)
    assert pw.returncode == 0, pw.stdout[-3000:] + pw.stderr[-3000:]
    assert len(_losses(pw.stdout, r"\] loss")) == 2
    ck = tmp_path / "pw" / "pwave_BS1_LR0.0001" / "checkpoint_best_loss"
    assert json.loads((ck / "meta.json").read_text())["epoch"] == 0
    assert "valid loss" in pw.stdout
    # the epoch's first validation picture, as the JAX trainer draws it
    web = tmp_path / "pw" / "pwave_BS1_LR0.0001" / "web"
    assert sorted(p.name for p in (web / "images").iterdir()) == [
        f"epoch000_eval_{k}.png" for k in ("lvl0_subbands", "lvl1_subbands", "lvl2_subbands",
                                           "lvl3_subbands", "x", "x_hat")]
    assert "<h3>epoch 0 [eval]</h3>" in (web / "index.html").read_text()


def test_train_pmctf_cli_lossless(tmp_path):
    """--lossless (train_pmctf.py:39,114,145): a lossless PMCTF on YCoCg
    frames; its GOP-2 step reconstructs exactly (mse 0, as JAX's lossless
    step does), and its checkpoint loads into a lossless model."""
    import torch
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    data = tmp_path / "vimeo"
    write_vimeo_pngs(str(data), sequences=2, frames=8, h=64, w=72)
    (tmp_path / "one.json").write_text(json.dumps({
        "total_epochs": 1, "train_lambda": [1, 27], "num_stages": 10,
        "lr": [1e-5], "parts": ["All"], "num_frames": [2],
        "frame_interval": [1], "num_epochs": [1]}))
    run = _cli("learned_pmctf_tpu_torch.cli.train_pmctf",
               ["-d", str(data), "--batch-size", "1", "--patchsize", "64", "64",
                "--steps_per_epoch", "1", "--log_every", "1", "--device", "cpu",
                "--warp_mode", "exact", "--num-workers", "1", "--fix_q", "10",
                "--lossless", "--config", str(tmp_path / "one.json")], tmp_path)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert _losses(run.stdout, "mse") == [0.0]
    assert all(v > 0 for v in _losses(run.stdout, "bppH"))
    ck = tmp_path / "experiments" / "pmctf_BS1" / "state_epoch0" / "params.pt"
    model = build_pmctf("cpu", lossy=False)
    model.load_state_dict(torch.load(ck, weights_only=True), strict=True)


def test_train_pwave_cli_lossless(tmp_path):
    """--lossless (train_pwave.py:40,91,126-127): the lossless pWave on
    rounded batches; each step and the validation reconstruct exactly."""
    data = tmp_path / "vimeo"
    write_vimeo_pngs(str(data), sequences=2, frames=8, h=64, w=72)
    pw = _cli("learned_pmctf_tpu_torch.cli.train_pwave",
              ["-d", str(data), "--epochs", "1", "--batch-size", "1",
               "--test-batch-size", "2", "--patch-size", "64", "64",
               "--steps_per_epoch", "2", "--device", "cpu", "-n", "1", "--lossless",
               "--experiments_root", str(tmp_path / "pw")], tmp_path)
    assert pw.returncode == 0, pw.stdout[-3000:] + pw.stderr[-3000:]
    assert _losses(pw.stdout, r"\] loss") and _losses(pw.stdout, "mse") == [0.0, 0.0]
    assert "valid loss" in pw.stdout
