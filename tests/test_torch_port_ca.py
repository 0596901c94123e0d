"""Port parity, motion estimation on a downsampled plane (me_downsample)
and the content-adaptive CLI (cli/ca.py, the port of test_pmctf_ca.py).

me_downsample 2 (128x128 frames) and 4 (256x256: SpyNet's pyramid needs
64 pixels after downsampling) through the port's estimate stage against
the JAX model's eager stage, tolerances as tests/test_torch_port_models.py
holds forward_one_stage (planes 5e-3 abs, bits rel 5e-3; marked slow:
the eager JAX stage at those sizes takes 60 to 120 s); and through the
port's stream stage: every decoded plane equal to the encoder side, bit
for bit (the MV hyper-latent is decoded at the downsampled plane's shape;
JAX's PMCTFCodec.decompress_mv decodes it at the full frame's, ROADMAP.md
C; factor 4 at 256x256 marked slow).

cli/ca.py's run_test against the JAX CLI's run_test driven with the
port's codec (as tests/test_torch_port_eval.py drives test_pmctf_flex.py)
on the same synthetic frames: the same gop_choice, ds_choice and
tested_opts, per-frame bits exact and PSNRs within 1e-4 dB.
"""

import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import test_pmctf_ca as jax_ca
from learned_pmctf_tpu_torch.cli import ca, flex
from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
from learned_pmctf_tpu_torch.models.pmctf import empty_dpb
from test_torch_port_eval import PortCodecForJaxCli
from test_torch_port_gop import synthetic_frames
from torch_port_helpers import (assert_close, assert_rel, jax_small_model,  # noqa: F401
                                jax_small_params, numerics, port_small_model)

Q = 10.0
SIZE = {2: 128, 4: 256}  # frame size a factor needs


@pytest.fixture(scope="module")
def models():
    params = jax_small_params(seed=6)
    return (jax_small_model(), jax.tree_util.tree_map(jnp.asarray, params),
            port_small_model(params))


@pytest.mark.slow  # the eager JAX stage at 128x128 and 256x256: 60 to 120 s each
@pytest.mark.parametrize("ds", [2, 4])
def test_me_downsample_estimate_matches_jax(models, ds):
    jm, jp, port = models
    luma, _ = synthetic_frames(2, SIZE[ds], SIZE[ds])
    ref = jm.apply(jp, jnp.asarray(luma[0]), jnp.asarray(luma[1]), jnp.float32(Q), True,
                   empty_dpb(), stage_idx=0, me_downsample=ds, training=False)
    with torch.no_grad():
        got = port.forward_one_stage(torch.tensor(luma[0]), torch.tensor(luma[1]), Q, True,
                                     empty_dpb(), me_downsample=ds)
    assert got["mv_hat"].shape == (1, 2, SIZE[ds], SIZE[ds])
    for key in ("mv_hat", "L_t", "H_t"):
        assert_close(got[key], ref[key], 5e-3, f"ds{ds}[{key}]")
    for key in ("mv_feature", "ref_mv_y"):
        assert_close(got["dpb"][key], ref["dpb"][key], 5e-3, f"ds{ds}[dpb.{key}]")
    for key in ("bpp_H", "bpp_me", "bpp_L"):
        assert_rel(got[key], ref[key], 5e-3, f"ds{ds}[{key}]", floor=1e-2)


@pytest.mark.parametrize("ds", [2, pytest.param(4, marks=pytest.mark.slow)])
def test_me_downsample_stream_stage_decodes_exactly(models, ds, tmp_path):
    """encode_one_stage at a factor: the decoded motion and bands equal
    the encoder side, and the motion equals the estimate stage's."""
    _, _, port = models
    luma, chroma = synthetic_frames(2, SIZE[ds], SIZE[ds])
    ref = (torch.tensor(luma[0]), torch.tensor(chroma[0]))
    cur = (torch.tensor(luma[1]), torch.tensor(chroma[1]))
    with PMCTFCodec(port, device="cpu") as codec:
        codec.update()
        est = codec.estimate_one_stage(ref, cur, True, empty_dpb(), q_index=Q,
                                       me_downsample=ds)
        out = codec.encode_one_stage(ref, cur, True, empty_dpb(), str(tmp_path / "1.bin"),
                                     SIZE[ds], SIZE[ds], psize=128, q_index=Q,
                                     me_downsample=ds)
    side = out["encoder_side"]
    assert torch.equal(out["mv_hat"], side["mv_hat"])
    assert torch.equal(out["dpb"]["ref_mv_y"], side["mv_y_hat"])
    for key in ("H_t", "H_tc", "L_t", "L_tc"):
        assert torch.equal(out[key], side[key]), key
    assert_close(out["mv_hat"], est["mv_hat"], 1e-4, f"ds{ds} stream mv")


class CaCodec(PortCodecForJaxCli):
    """The adapter test_pmctf_flex.py's run_test takes, with the q count
    test_pmctf_ca.py's run_test reads from the module."""

    def __init__(self, codec):
        super().__init__(codec)
        self.module = types.SimpleNamespace(num_me_stages=codec.model.num_me_stages,
                                            get_qp_num=codec.model.get_qp_num)


CA_ARGS = ["--num_me_stages", "2", "--features", "16", "--ar_features", "16",
           "--channel_mv", "16", "--decomp_levels", "2", "--device", "cpu"]


def _seq_args(frames, gop, size, **extra):
    return dict({"q_idx": 10, "src_height": size, "src_width": size, "gop_size": gop,
                 "frame_num": frames, "frame_num_seq": frames, "synthetic": 1,
                 "skip_decoding": False}, **extra)


def test_ca_run_test_matches_jax_run_test():
    """8 synthetic 128x128 frames, one GOP-8 chunk: GOP sizes {8, 4},
    factors {1, 2}, searched by both CLIs on the port's codec."""
    codec = flex.build_codec(ca.parse_args(CA_ARGS))
    try:
        port = ca.run_test(codec, _seq_args(8, 8, 128))
        ref = jax_ca.run_test(CaCodec(codec), _seq_args(8, 8, 128))
    finally:
        codec.close()
    for key in ("gop_choice", "ds_choice", "tested_opts", "frame_type"):
        assert port[key] == ref[key], (key, port[key], ref[key])
    assert port["tested_opts"][0] >= 2
    assert port["frame_bpp"] == ref["frame_bpp"]
    np.testing.assert_allclose(port["frame_psnr"], ref["frame_psnr"], atol=1e-4)
    assert all(np.isfinite(port["frame_psnr"])) and all(b > 0 for b in port["frame_bpp"])


def test_ca_cli_streams_decode_exactly(tmp_path):
    """cli.ca with --write_stream on 4 frames at 128x128: both factors
    are coded to streams and decoded (a decoded plane that differs from
    the encoder side stops the run); the JSON has the chunk's choices."""
    import json
    out = tmp_path / "ca.json"
    ca.main(CA_ARGS + ["--synthetic", "4", "--synthetic_size", "128x128",
                       "--force_intra_period", "4", "--q_index", "10",
                       "--write_stream", "1", "--stream_path", str(tmp_path / "bin"),
                       "--output_path", str(out)])
    log = json.loads(out.read_text())["synthetic_ds"]["synthetic"]
    assert log["gop_choice"] == [4] and log["ds_choice"][0] in (1, 2)
    assert all(np.isfinite(log["frame_psnr"])) and all(b > 0 for b in log["frame_bpp"])
