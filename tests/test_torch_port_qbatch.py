"""Port parity, the q-batched estimate path: PMCTFCodec's
estimate_one_stage_multi and inverse_mctf_multi (Q rate points, or
sequences x rate points, as one batch along the model's batch axis)
against Q single-q port runs and against the JAX model's eager single-q
stage, and the eval CLI's --q_batch and --seq_batch against per-q runs.

The small config of torch_port_helpers.py with its q scales spread (QP
and QP_ll to [0.02, 0.5], the MV and highpass stage scales to [0.5, 2])
so that every rate point codes differently. Tolerances: bits rel 1e-4,
planes 5e-2 abs (the GOP tests' bounds); the CLI's JSON the same up to
its wall times (bits rel 1e-4, PSNR 1e-4 dB). The test against JAX's
eager stage is marked slow; the others run in tier-1.
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu_torch.cli import flex
from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
from learned_pmctf_tpu_torch.models.pmctf import empty_dpb
from learned_pmctf_tpu_torch.utils.yuv import YUVWriter
from test_torch_port_gop import synthetic_frames
from torch_port_helpers import (jax_small_model, jax_small_params, numerics,  # noqa: F401
                                port_small_model)

Q_LIST = (0, 20)
BITS_REL, PLANE_ABS = 1e-4, 5e-2


def spread_q(params):
    p = params["params"]
    for coder in ("lp_coder", "hp_coder"):
        for key in ("QP", "QP_ll"):
            p[coder][key] = np.array([0.02, 0.5], np.float32).reshape(2, 1, 1, 1)
    for key in ("mv_y_q_scale_enc", "mv_y_q_scale_dec", "hp_q_scale"):
        p[key] = np.broadcast_to(np.array([0.5, 2.0], np.float32).reshape(1, 2, 1, 1, 1),
                                 p[key].shape).copy()
    return params


@pytest.fixture(scope="module")
def models():
    params = spread_q(jax_small_params(seed=2))
    return (jax_small_model(), jax.tree_util.tree_map(jnp.asarray, params),
            port_small_model(params))


def stacked(frames, n):
    """(y, chroma) of one frame, repeated along a leading element axis."""
    return tuple(torch.from_numpy(f)[None].repeat(n, *([1] * f.ndim)) for f in frames)


def assert_rel(got, want, what):
    assert abs(float(got) - float(want)) <= BITS_REL * max(abs(float(want)), 1.0), (
        what, float(got), float(want))


def assert_planes(got, want, what):
    err = float((got - want).abs().max())
    assert err < PLANE_ABS, (what, err)


@pytest.mark.slow  # the eager JAX stage at two q indexes: 35 to 70 s
def test_multi_stage_matches_single_q_runs_and_jax(models):
    """estimate_one_stage_multi at Q = 2 against estimate_one_stage at
    each q (port), and its luma planes and the per-sample luma rates
    against the JAX model's eager stage at each q."""
    jm, jp, port = models
    luma, chroma = synthetic_frames(2)
    ref, cur = (luma[0], chroma[0]), (luma[1], chroma[1])
    with PMCTFCodec(port, device="cpu") as codec:
        multi = codec.estimate_one_stage_multi(stacked(ref, 2), stacked(cur, 2), True,
                                               empty_dpb(), list(Q_LIST))
        assert multi["bit_H"].shape == (2,) and multi["L_t"].shape == (2, 1, 1, 64, 64)
        assert multi["L_tc"].shape == (2, 2, 1, 32, 32)
        singles = [codec.estimate_one_stage(tuple(map(torch.from_numpy, ref)),
                                            tuple(map(torch.from_numpy, cur)), True,
                                            empty_dpb(), q_index=q) for q in Q_LIST]
    assert multi["bit_H"][0] != multi["bit_H"][1]  # the rate points differ
    dpb0 = {"mv_feature": None, "ref_mv_y": None}
    for i, (q, single) in enumerate(zip(Q_LIST, singles)):
        for key in ("bit_H", "bit_L", "bit_ME"):
            assert_rel(multi[key][i], single[key], (q, key))
        for key in ("L_t", "H_t", "L_tc", "H_tc", "mv_hat"):
            assert_planes(multi[key][i], single[key], (q, key))
        # the JAX stage on luma (its chroma pass is the same stage with
        # the halved MVs, which the port's single-q runs above cover)
        out = jm.apply(jp, jnp.asarray(ref[0]), jnp.asarray(cur[0]), jnp.float32(q), True,
                       dpb0, stage_idx=0, training=False)
        with torch.no_grad():
            luma = port.forward_one_stage(
                torch.from_numpy(ref[0]), torch.from_numpy(cur[0]),
                torch.tensor([float(q)]), True, empty_dpb(), per_sample=True)
        for key in ("bit_H", "bit_L", "bit_ME"):
            assert_rel(luma[key][0], out[key], (q, "jax", key))
        for key in ("L_t", "H_t", "mv_hat"):
            assert_planes(multi[key][i], torch.from_numpy(np.array(out[key])), (q, "jax", key))


def test_multi_ladder_with_a_dpb_matches_single_q(models):
    """Two sequences x two rate points (E = 4) through a GOP-4's three
    pairs (a DPB carried between the first two) and the inverse ladder,
    against the single-q runs of each element."""
    _, _, port = models
    seqs = [synthetic_frames(4, seed=s) for s in (21, 22)]
    elems = [(s, q) for s in range(2) for q in Q_LIST]

    def frame(i):
        ys = torch.stack([torch.from_numpy(seqs[s][0][i]) for s, _ in elems])
        cs = torch.stack([torch.from_numpy(seqs[s][1][i]) for s, _ in elems])
        return ys, cs

    sched = [(0, 0, 1, False), (0, 2, 1, False), (1, 0, 2, True)]
    with PMCTFCodec(port, device="cpu") as codec:
        fr = [frame(i) for i in range(4)]
        mvs, bits, dpb = [None] * 4, {}, empty_dpb()
        for stage, fi, step, code_lt in sched:
            if fi == 0:
                dpb = empty_dpb()
            res = codec.estimate_one_stage_multi(fr[fi], fr[fi + step], code_lt, dpb,
                                                 [q for _, q in elems], stage_idx=stage)
            dpb = res["dpb"]
            fr[fi], fr[fi + step] = (res["L_t"], res["L_tc"]), (res["H_t"], res["H_tc"])
            mvs[fi + step] = res["mv_hat"]
            bits[fi + step] = res["bit_H"] + res["bit_ME"]
            if code_lt:
                bits[fi] = res["bit_L"]
        for stage, fi, step, _ in reversed(sched):
            ry, cy = codec.inverse_mctf_multi(fr[fi][0], fr[fi + step][0], mvs[fi + step],
                                              stage_idx=stage)
            rc, cc = codec.inverse_mctf_multi(fr[fi][1], fr[fi + step][1], mvs[fi + step],
                                              stage_idx=stage, downscale=True)
            fr[fi], fr[fi + step] = (ry, rc), (cy, cc)

        for e, (s, q) in enumerate(elems):
            fl = [(torch.from_numpy(seqs[s][0][i]), torch.from_numpy(seqs[s][1][i]))
                  for i in range(4)]
            one_mvs, one_bits = [None] * 4, {}
            for stage, fi, step, code_lt in sched:
                if fi == 0:
                    dpb = empty_dpb()
                res = codec.estimate_one_stage(fl[fi], fl[fi + step], code_lt, dpb,
                                               stage_idx=stage, q_index=q)
                dpb = res["dpb"]
                fl[fi], fl[fi + step] = (res["L_t"], res["L_tc"]), (res["H_t"], res["H_tc"])
                one_mvs[fi + step] = res["mv_hat"]
                one_bits[fi + step] = res["bit_H"] + res["bit_ME"]
                if code_lt:
                    one_bits[fi] = res["bit_L"]
            for stage, fi, step, _ in reversed(sched):
                ry, cy = codec.inverse_mctf(fl[fi][0], fl[fi + step][0], one_mvs[fi + step],
                                            stage_idx=stage)
                rc, cc = codec.inverse_mctf(fl[fi][1], fl[fi + step][1], one_mvs[fi + step],
                                            stage_idx=stage, downscale=True)
                fl[fi], fl[fi + step] = (ry, rc), (cy, cc)
            for i in range(4):
                assert_rel(bits[i][e], one_bits[i], (e, i, "bits"))
                assert_planes(fr[i][0][e], fl[i][0], (e, i, "luma"))
                assert_planes(fr[i][1][e], fl[i][1], (e, i, "chroma"))


SMALL_ARGS = ["--force_intra_period", "4", "--num_me_stages", "2", "--features", "16",
              "--ar_features", "16", "--channel_mv", "16", "--decomp_levels", "2",
              "--device", "cpu", "--q_index_num", "2"]


def _logs(path):
    out = {}
    for p in sorted(path.parent.glob("out_qidx*.json")):
        for ds in json.loads(p.read_text()).values():
            for seq, log in ds.items():
                out[(p.name, seq)] = log
    return out


def _same_logs(batched, per_q):
    assert set(batched) == set(per_q) and len(per_q) >= 2
    for key, log in per_q.items():
        got = batched[key]
        for k, v in log.items():
            if "time" in k or k == "AVERAGE":
                continue
            if isinstance(v, list):
                assert len(got[k]) == len(v), (key, k)
                for a, b in zip(got[k], v):
                    tol = 1e-4 if "psnr" in k else 0.0 if "type" in k else BITS_REL * max(abs(b), 1.0)
                    assert abs(a - b) <= tol, (key, k, a, b)
            elif isinstance(v, float):
                assert abs(got[k] - v) <= 1e-4 * max(abs(v), 1.0), (key, k, got[k], v)
            else:
                assert got[k] == v, (key, k)


def test_cli_q_batch_matches_per_q_runs(tmp_path):
    args = SMALL_ARGS + ["--synthetic", "4", "--synthetic_size", "64x64"]
    flex.main(args + ["--output_path", str(tmp_path / "per_q" / "out.json")])
    flex.main(args + ["--q_batch", "--output_path", str(tmp_path / "batch" / "out.json")])
    _same_logs(_logs(tmp_path / "batch" / "out.json"), _logs(tmp_path / "per_q" / "out.json"))


def test_cli_seq_batch_matches_per_q_runs(tmp_path):
    """Two YUV sequences of one geometry coded together (--seq_batch 2)
    with both rate points, against each sequence coded per q."""
    g = np.random.default_rng(5)
    root = tmp_path / "yuv"
    seqs = {}
    for name in ("a", "b"):
        w = YUVWriter(str(root / "set" / f"{name}.yuv"))
        (root / "set").mkdir(parents=True, exist_ok=True)
        for _ in range(4):
            w.write_one_frame(g.integers(0, 256, (64, 64)).astype(np.uint8),
                              g.integers(0, 256, (32, 32)).astype(np.uint8),
                              g.integers(0, 256, (32, 32)).astype(np.uint8))
        seqs[name] = {"width": 64, "height": 64, "frames": 4, "gop": 4}
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"root_path": str(root), "test_classes": {"set": {
        "test": 1, "base_path": "set", "src_type": "yuv420", "sequences": seqs}}}))
    args = SMALL_ARGS + ["--test_config", str(cfg)]
    flex.main(args + ["--output_path", str(tmp_path / "per_q" / "out.json")])
    flex.main(args + ["--seq_batch", "2", "--output_path",
                      str(tmp_path / "batch" / "out.json")])
    _same_logs(_logs(tmp_path / "batch" / "out.json"), _logs(tmp_path / "per_q" / "out.json"))
