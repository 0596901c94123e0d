"""Port parity, the real-bitstream path: the model sub-graphs the codecs
call against their flax counterparts (eagerly, never through the JAX
package's jitted codec), and the port's PWaveCodec and PMCTFCodec round
trips on the CPU (decoded == encoder side, bit for bit; bytes stable
across encodes). The stream GOP against the JAX package's estimate
ladder is in tests/test_torch_port_gop.py, beside the estimate GOP, so
that the two share one run of the JAX ladder.

Small config and 64x64 luma / 32x32 chroma, as tests/test_torch_port_models.py.

(The model sub-graphs are in test_torch_port_codec_2.py, the decode
helpers and PWaveCodec round trips in _3.py; they import this file's
fixtures.)
"""

import os

import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.models.pwave import PWave as JaxPWave

from learned_pmctf_tpu_torch.codec.image_codec import PWaveCodec
from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
from learned_pmctf_tpu_torch.gop import stream_gop
from learned_pmctf_tpu_torch.models.pmctf import empty_dpb
from test_torch_port_gop import synthetic_frames
from torch_port_helpers import (SMALL, jax_small_model, jax_small_params, numpy_of,
                                port_small_model)

Q = 10.0
PSIZE = 64  # the frames are 64x64: padded to 64 already


@pytest.fixture(scope="module", autouse=True)
def _numerics():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_default_matmul_precision", old)


@pytest.fixture(scope="module")
def models():
    params = jax_small_params(seed=1)
    return (jax_small_model(), jax.tree_util.tree_map(jnp.asarray, params),
            port_small_model(params))


@pytest.fixture(scope="module")
def codec(models):
    with PMCTFCodec(models[2], device="cpu") as c:
        c.update()
        yield c


def jax_pwave():
    return JaxPWave(decomp_levels=SMALL["decomp_levels"], features=SMALL["features"],
                    ar_features=SMALL["ar_features"])


def t(x):
    return torch.tensor(numpy_of(x))


# ---- the model sub-graphs the codecs call -----------------------------------


# ---- round trips ---------------------------------------------------------------


def _bin_files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def test_pmctf_codec_gop4_round_trip(codec, tmp_path):
    luma, chroma = synthetic_frames(4)
    d1, d2 = tmp_path / "decode", tmp_path / "encode_only"
    d1.mkdir()
    d2.mkdir()
    dec = stream_gop(codec, luma, chroma, Q, str(d1), psize=PSIZE, device="cpu")
    enc = stream_gop(codec, luma, chroma, Q, str(d2), psize=PSIZE,
                     skip_decoding=True, device="cpu")
    assert len(dec["max_err"]) == 3 and set(dec["max_err"].values()) == {0.0}
    assert enc["max_err"] == {}
    for plane in ("luma", "chroma"):
        for a, b in zip(dec[plane], enc[plane]):
            assert torch.equal(a, b)
    files = _bin_files(d1)
    assert set(files) == {"s0_0.bin", "s0_0_C_main.bin", "s0_0_mv.bin",
                          "s0_1.bin", "s0_1_C_main.bin", "s0_1_mv.bin",
                          "s1_0.bin", "s1_0_C_main.bin", "s1_0_mv.bin",
                          "0_main.bin", "0_C_main.bin"}
    assert files == _bin_files(d2)  # bytes identical across encodes
    assert dec["bits"] == enc["bits"]
    assert dec["bits"][3]["bit_ME"] == 8 * len(files["s0_1_mv.bin"])
    assert dec["bits"][0]["bit_L"] == 8 * (len(files["0_main.bin"])
                                           + len(files["0_C_main.bin"]))


def test_pmctf_codec_decode_async(codec, tmp_path):
    luma, chroma = synthetic_frames(4)
    (tmp_path / "a").mkdir()
    (tmp_path / "s").mkdir()
    out = stream_gop(codec, luma, chroma, Q, str(tmp_path / "a"), psize=PSIZE,
                     decode_async=True, device="cpu")
    ref = stream_gop(codec, luma, chroma, Q, str(tmp_path / "s"), psize=PSIZE,
                     device="cpu")
    assert len(out["max_err"]) == 3 and set(out["max_err"].values()) == {0.0}
    assert codec._pending_decodes == []
    assert _bin_files(tmp_path / "a") == _bin_files(tmp_path / "s")
    for plane in ("luma", "chroma"):
        for a, b in zip(out[plane], ref[plane]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("check,strict", [(True, True), (True, False),
                                          (False, True)])
def test_pmctf_codec_drain_decodes_check_and_strict(codec, tmp_path, check, strict):
    """A deferred decode held against an encoder-side plane made one
    off: check=True measures it, strict=True raises on it, check=False
    measures nothing."""
    luma, chroma = synthetic_frames(2)
    f = [(torch.tensor(y), torch.tensor(c)) for y, c in zip(luma, chroma)]
    codec.encode_one_stage(f[0], f[1], True, empty_dpb(),
                           str(tmp_path / "s0_0.bin"), 64, 64, psize=PSIZE,
                           decode_async=True)
    expect = codec._pending_decodes[0]["expect"]
    expect["H_t"] = expect["H_t"] + 1.0
    if check and strict:
        with pytest.raises(ValueError, match="deferred decode mismatch"):
            codec.drain_decodes(check, strict)
        assert codec._pending_decodes == []
        return
    (got,) = codec.drain_decodes(check, strict)
    assert codec._pending_decodes == []
    assert got["name"] == str(tmp_path / "s0_0.bin")
    if check:
        assert set(got["errs"]) == {"mv_hat", "mv_y_hat", "H_t", "H_tc", "L_t",
                                    "L_tc"}
        # one off, give or take the rounding of the f32 sum
        assert got["errs"]["H_t"] == got["max_err"] > 0.5
        assert {v for k, v in got["errs"].items() if k != "H_t"} == {0.0}
    else:
        assert got["errs"] == {} and got["max_err"] == 0.0
    assert set(got["decoded"]) == {"mv", "luma", "chroma"}


def test_pmctf_codec_close_refuses_undrained_decodes(models, tmp_path):
    _, _, port = models
    luma, chroma = synthetic_frames(2)
    f = [(torch.tensor(y), torch.tensor(c)) for y, c in zip(luma, chroma)]
    codec = PMCTFCodec(port, device="cpu")
    codec.update()
    codec.encode_one_stage(f[0], f[1], True, empty_dpb(),
                           str(tmp_path / "s0_0.bin"), 64, 64, psize=PSIZE,
                           decode_async=True)
    with pytest.raises(RuntimeError, match="undrained"):
        codec.close()
    assert codec._pending_decodes == []
    codec.close()  # the pools are gone, nothing is pending: a no-op


def test_pmctf_codec_exit_lets_the_block_error_surface(models, tmp_path):
    """An exception raised inside the `with` block while a deferred
    decode is still queued surfaces with its own type (not close()'s
    RuntimeError); the pools are shut down and the queue cleared all the
    same."""
    _, _, port = models
    luma, chroma = synthetic_frames(2)
    f = [(torch.tensor(y), torch.tensor(c)) for y, c in zip(luma, chroma)]
    with pytest.raises(KeyError, match="raised in the block") as info:
        with PMCTFCodec(port, device="cpu") as codec:
            codec.update()
            codec.encode_one_stage(f[0], f[1], True, empty_dpb(),
                                   str(tmp_path / "s0_0.bin"), 64, 64, psize=PSIZE,
                                   decode_async=True)
            assert len(codec._pending_decodes) == 1
            raise KeyError("raised in the block")
    assert not isinstance(info.value.__context__, RuntimeError)
    assert codec._pending_decodes == [] and codec._decode_pool is None


def test_codecs_refuse_a_model_on_another_device(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="model is on cpu"):
        PMCTFCodec(models[2], device="cuda")
    with pytest.raises(ValueError, match="module is on cpu"):
        PWaveCodec(models[2].hp_coder, device="cuda")
