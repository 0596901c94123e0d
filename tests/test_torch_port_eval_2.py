"""Port parity, the eval surface: metrics, colour conversions, padding, the
eval JSON and YUV files against the JAX package. Tolerances (torch and
XLA round log10 and the blur sums apart): PSNR 1e-5 dB, MS-SSIM 5e-6
(measured 2e-6 at 192x192), colour conversions 1e-4 at 8-bit scale
(bilinear upsampling differs by 3e-5), padding, JSON text and YUV bytes
exact. The CLI's tests are in test_torch_port_eval.py.
"""

import io

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.ops import color as jcolor
from learned_pmctf_tpu.utils import eval_json as jeval
from learned_pmctf_tpu.utils import metrics as jmetrics
from learned_pmctf_tpu.utils import yuv as jyuv
from learned_pmctf_tpu.utils.stream import get_padding_size as jax_padding
from learned_pmctf_tpu_torch.ops import color
from learned_pmctf_tpu_torch.utils import eval_json, metrics, yuv
from learned_pmctf_tpu_torch.utils.stream import get_padding_size
from test_torch_port_eval import _threads


def _pair(seed, shape):
    g = np.random.default_rng(seed)
    a = g.integers(0, 256, shape).astype(np.float32)
    b = np.clip(a + g.normal(0, 8, shape), 0, 255).round().astype(np.float32)
    return a, b


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
