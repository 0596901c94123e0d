"""Port parity, the eval surface: the fixed-GOP CLI (cli/flex.py) against
the JAX package's test_pmctf_flex.py, lossy and lossless (metrics,
colour conversions, padding, the eval JSON and YUV files are in
test_torch_port_eval_2.py).

The JAX CLI is driven with the port's own codec behind the interface its
run_test calls (jnp arrays in and out, the JAX CLI's build_codec replaced
for the test), so that both CLIs code the same model and frames and the
comparison is of the loops, the metrics and the JSON: same files, same
keys, bits equal, metrics within the metrics' tolerances.

Tolerances (torch and XLA round log10 and the blur sums apart): PSNR
1e-5 dB, MS-SSIM 5e-6 (measured 2e-6 at 192x192), colour conversions
1e-4 at 8-bit scale (bilinear upsampling differs by 3e-5), padding, JSON
text and YUV bytes exact; the CLI's per-frame PSNRs 1e-4 dB after its
JSON's rounding to 6 digits, its bits exact.
"""

import json
import math
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F

import test_pmctf_flex as jax_flex

from learned_pmctf_tpu_torch.cli import flex
from learned_pmctf_tpu_torch.gop import code_gop


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


# ---- metrics, colour, padding ---------------------------------------------------


# ---- JSON and YUV files -------------------------------------------------------------


# ---- the CLI -----------------------------------------------------------------------

SMALL_ARGS = ["--synthetic", "4", "--synthetic_size", "64x64",
              "--force_intra_period", "4", "--num_me_stages", "2",
              "--ll_mode", "ar", "--features", "16", "--ar_features", "16",
              "--channel_mv", "16", "--decomp_levels", "2"]


class PortCodecForJaxCli:
    """The port's PMCTFCodec behind the calls the JAX CLI's run_test
    makes: jnp arrays in and out, the DPB passed through untouched."""

    def __init__(self, codec):
        self.codec = codec
        self.module = types.SimpleNamespace(num_me_stages=codec.model.num_me_stages)

    @staticmethod
    def _t(x):
        return torch.from_numpy(np.array(x))

    def _out(self, res):
        return {k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v
                for k, v in res.items()}

    def estimate_one_stage(self, ref, cur, code_lt, dpb, **kw):
        return self._out(self.codec.estimate_one_stage(
            tuple(map(self._t, ref)), tuple(map(self._t, cur)), code_lt, dpb, **kw))

    def encode_one_stage(self, ref, cur, code_lt, dpb, **kw):
        return self._out(self.codec.encode_one_stage(
            tuple(map(self._t, ref)), tuple(map(self._t, cur)), code_lt, dpb, **kw))

    def inverse_mctf(self, l_t, h_t, mv, **kw):
        return tuple(jnp.asarray(t.numpy()) for t in self.codec.inverse_mctf(
            self._t(l_t), self._t(h_t), self._t(mv), **kw))

    def drain_decodes(self):
        return self.codec.drain_decodes()


def _compare(port, ref, path=""):
    """Same keys at every level; bits exact; metrics within tolerance;
    wall times not compared."""
    assert type(port) is type(ref), path
    if isinstance(ref, dict):
        assert set(port) == set(ref), (path, set(port) ^ set(ref))
        for k in ref:
            _compare(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            _compare(p, r, f"{path}[{i}]")
    elif isinstance(ref, float) and "time" not in path and math.isinf(ref):
        assert port == ref, (path, port, ref)  # a lossless frame's PSNR
    elif isinstance(ref, float) and "time" not in path:
        tol = 1e-4 if "psnr" in path else 5e-6 if "ssim" in path else 0.0
        assert abs(port - ref) <= tol, (path, port, ref)
    elif "time" not in path:
        assert port == ref, (path, port, ref)


def _outputs(path, q_list):
    out = {}
    for name in [f"_qidx{q}" for q in q_list] + ["_summary"]:
        with open(str(path).replace(".json", f"{name}.json")) as f:
            out[name] = json.load(f)
    return out


def _run_both(tmp_path, monkeypatch, extra, q_list, stream=False):
    """Both CLIs into tmp_path/{port,jax}: their JSON compared, and their
    decoded frames (--save_decoded_frame) byte for byte."""
    port_out, jax_out = tmp_path / "port" / "out.json", tmp_path / "jax" / "out.json"
    port_extra, jax_extra = [
        extra + ["--save_decoded_frame", "1", "--decoded_frame_path", str(tmp_path / f"dec_{n}")]
        + (["--stream_path", str(tmp_path / f"bin_{n}")] if stream else [])
        for n in ("port", "jax")]
    flex.main(SMALL_ARGS + port_extra + ["--output_path", str(port_out), "--device", "cpu"])
    codec = flex.build_codec(flex.parse_args(SMALL_ARGS + port_extra + ["--device", "cpu"]))
    monkeypatch.setattr(jax_flex, "build_codec", lambda args: PortCodecForJaxCli(codec))
    jax_flex.main(SMALL_ARGS + jax_extra + ["--output_path", str(jax_out)])
    codec.close()
    port, ref = _outputs(port_out, q_list), _outputs(jax_out, q_list)
    _compare(port, ref)
    lossless = "--lossless" in extra
    for name in port:
        if name == "_summary":
            continue
        log = port[name]["synthetic_ds"]["synthetic"]
        assert all(b > 0 for b in log["frame_bpp"])
        if lossless:  # the decoded frames are the input: PSNR inf
            assert all(np.isposinf(log["frame_psnr"] + log["frame_psnr_rgb"]))
        else:
            assert all(np.isfinite(log["frame_psnr"] + log["frame_psnr_rgb"]))
        assert log["frame_type"] == [0, 1, 1, 1]
    for q in q_list:
        yuv_files = [tmp_path / f"dec_{n}" / "synthetic" / f"q{q}" / "decoded.yuv"
                     for n in ("port", "jax")]
        frames = [f.read_bytes() for f in yuv_files]
        assert frames[0] == frames[1] and len(frames[0]) == 4 * 64 * 64 * 3 // 2
    return codec, port


def test_cli_estimate_matches_jax_cli_and_code_gop(tmp_path, monkeypatch):
    codec, port = _run_both(tmp_path, monkeypatch, ["--q_index_num", "2"], [0, 20])
    # the same model and frames through gop.code_gop: the CLI's bits
    rng = np.random.default_rng(0)
    luma, chroma = [], []
    for _ in range(4):
        y = rng.integers(0, 256, (64, 64)).astype(np.float32)
        c = np.stack([rng.integers(0, 256, (32, 32)), rng.integers(0, 256, (32, 32))])
        luma.append(F.pad(torch.tensor(y)[None, None], (0, 64, 0, 64)))
        chroma.append(F.pad(torch.tensor(c.astype(np.float32))[:, None], (0, 32, 0, 32)))
    for q in (0, 20):
        bits = code_gop(codec.model, luma, chroma, q, device="cpu")["bits"]
        log = port[f"_qidx{q}"]["synthetic_ds"]["synthetic"]
        for fi in range(4):
            assert abs(log["frame_bpp"][fi] - sum(bits[fi].values()) / 4096) <= 5e-7, (q, fi)


def test_cli_write_stream_matches_jax_cli(tmp_path, monkeypatch):
    _, port = _run_both(tmp_path, monkeypatch,
                        ["--q_index", "10", "--write_stream", "1"], [10], stream=True)
    files = sorted(p.name for p in (tmp_path / "bin_port" / "synthetic" / "q10").iterdir())
    assert files == sorted(["0_main.bin", "0_C_main.bin"] + [
        f"{i}{s}.bin" for i in (1, 2, 3) for s in ("", "_C_main", "_mv")])
    log = port["_qidx10"]["synthetic_ds"]["synthetic"]
    assert log["avg_p_encoding_time_ms"] > 0 and log["avg_p_decoding_time_ms"] > 0


def test_cli_fast_warp_matches_jax_cli(tmp_path, monkeypatch):
    """--warp_mode fast (the JAX CLI takes it, test_pmctf_flex.py:77):
    the port's CLI against the JAX CLI driven with the port's fast-warp
    codec."""
    codec, port = _run_both(tmp_path, monkeypatch,
                            ["--q_index", "10", "--warp_mode", "fast"], [10])
    assert codec.model.warp_mode == "fast"
    assert codec.model.optic_flow.fast_warp


@pytest.mark.parametrize("stream", [False, pytest.param(True, marks=pytest.mark.slow)])
def test_cli_lossless_matches_jax_cli(tmp_path, monkeypatch, stream):
    """--lossless (test_pmctf_flex.py:50,117): the lossless model, every
    decoded frame the input (PSNR inf in both JSONs, as JAX's psnr gives
    it), from the estimate and from real streams."""
    extra = ["--q_index", "10", "--lossless"] + (["--write_stream", "1"] if stream else [])
    codec, port = _run_both(tmp_path, monkeypatch, extra, [10], stream=stream)
    assert not codec.model.lossy and not codec.model.hp_coder.lossy
