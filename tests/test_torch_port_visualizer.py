"""Port parity, utils/visualizer.py against the JAX package's: the
subband pictures of one seeded small PWave (weights through
convert.pwave_params_from_jax) from pwave_visuals, and the gallery the
Visualizer writes from them over two epochs. cli/train_pwave.py draws
them in test_torch_port_train_cli.py.

Tolerances: every array within 1e-4 of its largest magnitude (the
lifting in torch against XLA); the PNGs' 8-bit levels within 1 (a level
on a rounding edge may flip); the gallery's file names and index.html
equal.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from learned_pmctf_tpu.models.pwave import PWave as JaxPWave
from learned_pmctf_tpu.utils import visualizer as jax_vis
from learned_pmctf_tpu_torch.convert import pwave_params_from_jax
from learned_pmctf_tpu_torch.models.pwave import PWave
from learned_pmctf_tpu_torch.utils import visualizer
from test_torch_port_train_pwave import CFG, jax_pwave_params

ARRAY_REL, LEVELS = 1e-4, 1


@pytest.fixture(scope="module", autouse=True)
def _numerics():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_default_matmul_precision", old)


@pytest.fixture(scope="module")
def visuals():
    params = jax_pwave_params("fourstep", seed=3)
    g = np.random.default_rng(4)
    x = g.integers(0, 256, (1, 1, 64, 64)).astype(np.float32)
    x_hat = (x + g.normal(0, 12, x.shape)).astype(np.float32)  # some outside [0, 255]
    want = jax_vis.pwave_visuals(JaxPWave(ll_mode="fourstep", **CFG),
                                 jax.tree_util.tree_map(jnp.asarray, params),
                                 jnp.asarray(x), jnp.asarray(x_hat))
    model = PWave(ll_mode="fourstep", **CFG)
    model.load_state_dict(pwave_params_from_jax(params), strict=True)
    got = visualizer.pwave_visuals(model, torch.from_numpy(x), torch.from_numpy(x_hat))
    return got, want


def test_pwave_visuals_match_jax(visuals):
    """The same pictures: x, the clipped x_hat, and each level's
    ll|lh over hl|hh."""
    got, want = visuals
    assert list(got) == list(want) == ["x", "x_hat", "lvl0_subbands", "lvl1_subbands"]
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape and got[k].dtype == np.float32, k
        err = float(np.abs(got[k] - w).max())
        assert err <= ARRAY_REL * float(np.abs(w).max()), (k, err)
    assert got["x_hat"].min() >= 0 and got["x_hat"].max() <= 255


def test_gallery_matches_jax(visuals, tmp_path):
    """Two epochs (a train and an eval picture set) through both
    Visualizers: the same image files with 8-bit levels within 1, and the
    same index.html."""
    got, want = visuals
    for name, vis, mod in (("port", got, visualizer), ("jax", want, jax_vis)):
        v = mod.Visualizer(str(tmp_path / name))
        v.display_current_results(vis, 0, is_eval=True)
        v.display_current_results(vis, 1)
    webs = {name: tmp_path / name / "web" for name in ("port", "jax")}
    files = {name: sorted(p.name for p in (web / "images").iterdir())
             for name, web in webs.items()}
    assert files["port"] == files["jax"] and len(files["jax"]) == 8
    for f in files["jax"]:
        a, b = (np.asarray(Image.open(webs[n] / "images" / f), np.int16) for n in webs)
        assert a.shape == b.shape and int(np.abs(a - b).max()) <= LEVELS, f
        assert a.dtype == np.int16 and a.max() > a.min()
    assert (webs["port"] / "index.html").read_text() == (webs["jax"] / "index.html").read_text()
    for label in ("x", "x_hat", "lvl0_subbands"):
        assert visualizer.normalize_for_display(got[label], signed=False).dtype == np.uint8
    m = np.array([[-2.0, 0.0, 4.0]])
    assert np.array_equal(visualizer.normalize_for_display(m),
                          jax_vis.normalize_for_display(m))
