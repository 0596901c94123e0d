"""Port parity, the eval surface: metrics, colour conversions, padding,
the eval JSON, YUV files, and the fixed-GOP CLI (cli/flex.py) against the
JAX package's test_pmctf_flex.py.

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

import io
import json
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F

import test_pmctf_flex as jax_flex
from learned_pmctf_tpu.ops import color as jcolor
from learned_pmctf_tpu.utils import eval_json as jeval
from learned_pmctf_tpu.utils import metrics as jmetrics
from learned_pmctf_tpu.utils import yuv as jyuv
from learned_pmctf_tpu.utils.stream import get_padding_size as jax_padding

from learned_pmctf_tpu_torch.cli import flex
from learned_pmctf_tpu_torch.gop import code_gop
from learned_pmctf_tpu_torch.ops import color
from learned_pmctf_tpu_torch.utils import eval_json, metrics, yuv
from learned_pmctf_tpu_torch.utils.stream import get_padding_size


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _pair(seed, shape):
    g = np.random.default_rng(seed)
    a = g.integers(0, 256, shape).astype(np.float32)
    b = np.clip(a + g.normal(0, 8, shape), 0, 255).round().astype(np.float32)
    return a, b


# ---- metrics, colour, padding ---------------------------------------------------

@pytest.mark.parametrize("hw", [(192, 192), (256, 256)])
def test_psnr_and_ms_ssim_match_jax(hw):
    a, b = _pair(1, (1, 3) + hw)
    ref = float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b)))
    assert abs(float(metrics.psnr(torch.tensor(a), torch.tensor(b))) - ref) < 1e-5
    ref = float(jmetrics.ms_ssim(jnp.asarray(a), jnp.asarray(b)))
    got = float(metrics.ms_ssim(torch.tensor(a), torch.tensor(b)))
    assert abs(got - ref) < 5e-6, (got, ref)
    assert metrics.yuv_psnr(30.0, 40.0, 50.0) == jmetrics.yuv_psnr(30.0, 40.0, 50.0)


def test_colour_conversions_match_jax():
    g = np.random.default_rng(2)
    x = g.uniform(0, 255, (2, 3, 16, 24)).astype(np.float32)
    for fn in ("rgb_to_ycbcr", "ycbcr_to_rgb"):
        ref = np.asarray(getattr(jcolor, fn)(jnp.asarray(x)))
        np.testing.assert_allclose(getattr(color, fn)(torch.tensor(x)).numpy(), ref,
                                   rtol=0, atol=1e-4, err_msg=fn)
    for ref, got in zip(jcolor.yuv444_to_420(jnp.asarray(x)),
                        color.yuv444_to_420(torch.tensor(x))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    y, u, v = (g.uniform(0, 255, s).astype(np.float32)
               for s in ((2, 1, 16, 24), (2, 1, 8, 12), (2, 1, 8, 12)))
    for mode in ("linear", "nearest"):
        ref = np.asarray(jcolor.yuv420_to_444(*map(jnp.asarray, (y, u, v)), mode))
        got = color.yuv420_to_444(*map(torch.tensor, (y, u, v)), mode).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4, err_msg=mode)
    with pytest.raises(ValueError):
        color.yuv420_to_444(*map(torch.tensor, (y, u, v)), "cubic")


def test_padding_size_matches_jax():
    for h, w, p in ((1080, 1920, 128), (64, 64, 128), (240, 416, 64), (128, 256, 128)):
        assert get_padding_size(h, w, p) == jax_padding(h, w, p)
    assert get_padding_size(100, 30) == jax_padding(100, 30)


# ---- JSON and YUV files -------------------------------------------------------------

def test_eval_json_matches_jax():
    g = np.random.default_rng(3)
    n = 9
    args = (n, [0, 1, 1, 2, 1, None, 1, 1, 0], list(g.uniform(1e4, 1e5, n)),
            [0.0] + list(g.uniform(0, 0.1, n - 1)), list(g.uniform(25, 40, n)),
            list(g.uniform(25, 40, n)), list(g.uniform(0.9, 1, n)), 4096, 12.5)
    texts = []
    for mod in (jeval, eval_json):
        log = mod.generate_log_json(*args)
        log_opts = mod.generate_log_json(*args, gop_choice=[4, 8], ds_choice=[1],
                                         tested_opts=[1, 2, 3])
        text = []
        for obj, kw in ((log, dict(float_digits=6, indent=2)), (log_opts, {}),
                        ({"a": np.float32(1.25), "b": [np.int64(3), (1.0, 2.123456789)]},
                         dict(float_digits=3))):
            buf = io.StringIO()
            mod.dump_json(obj, buf, **kw)
            text.append(buf.getvalue())
        texts.append(text)
    assert texts[0] == texts[1]
    np.testing.assert_array_equal(eval_json.interpolate_log(0.1, 10.0, 5),
                                  jeval.interpolate_log(0.1, 10.0, 5))
    for v in ("yes", "0", True, "F"):
        assert eval_json.str2bool(v) == jeval.str2bool(v)


def test_yuv_files_match_jax(tmp_path):
    g = np.random.default_rng(4)
    frames = [(g.integers(0, 256, (16, 24)).astype(np.uint8),
               g.integers(0, 256, (8, 12)).astype(np.uint8),
               g.integers(0, 256, (8, 12)).astype(np.uint8)) for _ in range(3)]
    paths = {}
    for name, mod in (("jax", jyuv), ("port", yuv)):
        paths[name] = str(tmp_path / f"{name}.yuv")
        w = mod.YUVWriter(paths[name])
        for f in frames:
            w.write_one_frame(*f)
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    r = yuv.YUVReader(paths["port"], 24, 16, start_index=1)
    rj = jyuv.YUVReader(paths["jax"], 24, 16, start_index=1)
    for f in frames[1:]:
        got, ref = r.read_one_frame(), rj.read_one_frame()
        for a, b, c in zip(got, ref, f):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


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
    for name in port:
        if name == "_summary":
            continue
        log = port[name]["synthetic_ds"]["synthetic"]
        assert all(b > 0 for b in log["frame_bpp"])
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


@pytest.mark.parametrize("flag", [["--q_batch"], ["--seq_batch", "2"], ["--shard_q"],
                                  ["--lossless"]])
def test_cli_refuses_what_is_not_ported(flag, capsys):
    with pytest.raises(SystemExit):
        flex.parse_args(SMALL_ARGS + flag)
    assert "ROADMAP.md item" in capsys.readouterr().err
