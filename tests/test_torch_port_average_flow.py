"""Port parity, the dataset's flow filter: the RGB SpyNet
(models/spynet.py ``MESpynet(luma_mode=False)``, 8-input conv1) against
flax ``MESpynet(luma_mode=False)`` with the same weights
(convert.module_params_from_jax), and cli/average_flow.py against
create_dataset/average_flow.py's ``main`` on a seeded three-clip PNG
tree, both loading one SpyNet torch checkpoint (``--spynet``), the JAX
script jitted as it runs.

Tolerances: the flow within 1e-4 of its largest magnitude (torch's
convs and warps against XLA's, f32); the statistics' keys equal and each
clip's mean |flow| within 1e-4.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from learned_pmctf_tpu.models.spynet import MESpynet as JaxMESpynet
from learned_pmctf_tpu_torch.cli import average_flow
from learned_pmctf_tpu_torch.convert import load_reference_spynet, module_params_from_jax
from learned_pmctf_tpu_torch.models.layers import init_params
from learned_pmctf_tpu_torch.models.spynet import MESpynet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOW_REL, MAG_ABS = 1e-4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _numerics():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_default_matmul_precision", old)


def smooth_rgb(g, h, w, shift):
    """A smooth RGB picture (sums of waves), moved by `shift` pixels."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    yy, xx = yy - shift[0], xx - shift[1]
    img = np.zeros((h, w, 3))
    for c in range(3):
        for _ in range(3):
            fy, fx, ph = g.uniform(0.02, 0.12), g.uniform(0.02, 0.12), g.uniform(0, 6.3)
            img[..., c] += np.sin(fy * yy + fx * xx + ph)
    return np.clip(127.5 + 40.0 * img, 0, 255).astype(np.uint8)


def test_rgb_spynet_matches_flax():
    """A seeded 64x64 RGB pair (normalized to [0, 1]) through six levels:
    flax's init drawn (jitted, as the JAX script runs it), its weights in
    the port's RGB net."""
    g = np.random.default_rng(0)
    a = smooth_rgb(g, 64, 64, (0, 0)).transpose(2, 0, 1)[None] / 255.0
    b = smooth_rgb(np.random.default_rng(0), 64, 64, (1.5, -2.0)).transpose(2, 0, 1)[None] / 255.0
    a, b = a.astype(np.float32), b.astype(np.float32)
    module = JaxMESpynet(levels=6, luma_mode=False)
    params = jax.jit(module.init)(jax.random.PRNGKey(5), jnp.asarray(a), jnp.asarray(b))
    want = np.asarray(jax.jit(module.apply)(params, jnp.asarray(a), jnp.asarray(b)))
    port = MESpynet(levels=6, luma_mode=False)
    assert port.moduleBasic[0].conv1.weight.shape[1] == 8
    port.load_state_dict(module_params_from_jax(port, params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (1, 2, 64, 64)
    err = float(np.abs(got - want).max())
    assert err <= FLOW_REL * float(np.abs(want).max()), (err, float(np.abs(want).max()))
    assert MESpynet().moduleBasic[0].conv1.weight.shape[1] == 4  # luma stays the default


def write_clips(root, clips=3, frames=4, h=64, w=64):
    """Vimeo-32 style sequences/<seq>/<clip>/im<i>.png, each clip a
    smooth picture moving by its own speed, and one single-frame clip
    (skipped by both)."""
    for c in range(clips + 1):
        d = root / "sequences" / f"{c // 2 + 1:05d}" / f"{c % 2 + 1:04d}"
        d.mkdir(parents=True)
        n = frames if c < clips else 1
        for i in range(n):
            img = smooth_rgb(np.random.default_rng(c), h, w, (0.7 * c * i, -0.5 * c * i))
            Image.fromarray(img).save(d / f"im{i + 1}.png")


def test_cli_matches_the_jax_script(tmp_path, capsys):
    """The same statistics JSON from the port's CLI (CPU) and the JAX
    script, both reading a seeded RGB SpyNet checkpoint."""
    write_clips(tmp_path / "data")
    net = init_params(MESpynet(levels=6, luma_mode=False), torch.Generator().manual_seed(9))
    ckpt = tmp_path / "spynet.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in net.state_dict().items()}}, ckpt)
    loaded = load_reference_spynet(str(ckpt), MESpynet(levels=6, luma_mode=False))
    for k, v in net.state_dict().items():  # taken as it is: no RGB slices summed
        assert torch.equal(loaded.state_dict()[k], v), k
    port = average_flow.main(["--data", str(tmp_path / "data"), "--out",
                              str(tmp_path / "port.json"), "--spynet", str(ckpt),
                              "--device", "cpu"])
    spec = importlib.util.spec_from_file_location(
        "jax_average_flow", os.path.join(ROOT, "create_dataset", "average_flow.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.main(["--data", str(tmp_path / "data"), "--out", str(tmp_path / "jax.json"),
                 "--spynet", str(ckpt)])
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got == port and list(got) == list(want) == ["00001/0001", "00001/0002",
                                                        "00002/0001"]
    for k, v in want.items():
        assert abs(got[k] - v) <= MAG_ABS, (k, got[k], v)
    assert len({round(v, 3) for v in want.values()}) == 3  # the clips move apart
    assert "3 clips; mean |flow|" in capsys.readouterr().out
