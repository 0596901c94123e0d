"""Port parity, conv3x3: the port's fused 3x3 conv against the JAX
package's Pallas kernel (interpret mode) and its XLA oracle
(test_torch_port_conv3x3_2.py to _5.py, with the helpers here), and the
port's PostProcess against the JAX PostProcess.

On the CPU the wrapper runs its plain version; the CUDA kernels themselves
are held against the plain version on the card (the `cuda` test of
test_torch_port_conv3x3_card.py, and chip_smoke.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.models.postprocess import PostProcess as JaxPostProcess

from learned_pmctf_tpu_torch.models.postprocess import PostProcess
from learned_pmctf_tpu_torch.ops import conv3x3 as c3

SHAPES = [(1, 8, 64, 64), (2, 6, 1, 64), (1, 4, 64, 1), (1, 5, 16, 16)]
EPILOGUES = [(None, False), ("leaky_relu", False), (None, True), ("tanh", True)]


@pytest.fixture(scope="module", autouse=True)
def _numerics():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _case(n, h, c, o, width, res, seed=0):
    """Inputs in the Pallas kernel's (N, H, C, W) layout."""
    g = np.random.default_rng(seed)
    x = g.normal(0, 1, (n, h, c, width)).astype(np.float32)
    w = g.normal(0, 0.1, (o, c, 3, 3)).astype(np.float32)
    b = g.normal(0, 1, (o,)).astype(np.float32)
    r = g.normal(0, 1, (n, h, o, width)).astype(np.float32) if res else None
    return x, w, b, r


def _port(x, w, b, r, act):
    """Port conv3x3 on NCHW, returned in (N, H, O, W)."""
    nchw = lambda a: torch.tensor(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))  # noqa: E731
    y = c3.conv3x3(nchw(x), torch.tensor(w), torch.tensor(b), act=act,
                   residual=None if r is None else nchw(r))
    return y.numpy().transpose(0, 2, 1, 3)


def _jax_args(x, w, b, r):
    return (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            None if r is None else jnp.asarray(r))


def test_conv3x3_checks_its_inputs():
    x = torch.zeros(1, 4, 8, 8)
    w, b = torch.zeros(5, 4, 3, 3), torch.zeros(5)
    before = c3.conv3x3.launches
    assert c3.conv3x3(x, w, b).shape == (1, 5, 8, 8)
    assert c3.conv3x3.launches == before  # the CPU runs the plain version
    with pytest.raises(TypeError):
        c3.conv3x3(x.double(), w, b)
    with pytest.raises(ValueError):
        c3.conv3x3(x.transpose(2, 3), w, b)
    with pytest.raises(ValueError):
        c3.conv3x3(x, torch.zeros(5, 3, 3, 3), b)
    with pytest.raises(ValueError):
        c3.conv3x3(x, w, b, residual=torch.zeros(1, 4, 8, 8))
    with pytest.raises(ValueError):
        c3.conv3x3(x, w, b, act="relu")


def _jax_postprocess_params(channels, num_res, seed):
    """flax PostProcess params drawn with numpy (names from eval_shape)."""
    m = JaxPostProcess(channels=channels, num_res=num_res)
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 1, 16, 16), jnp.float32))
    g = np.random.default_rng(seed)
    return m, jax.tree_util.tree_map(
        lambda s: (g.normal(0, 0.05, s.shape)).astype(np.float32), shapes)


@pytest.mark.parametrize("batch,h,w", [(1, 32, 48), (2, 16, 40)])
def test_postprocess_matches_jax(batch, h, w):
    jm, params = _jax_postprocess_params(64, 6, seed=batch)
    x = np.random.default_rng(7).normal(0, 0.3, (batch, 1, h, w)).astype(np.float32)
    ref = jm.apply(params, jnp.asarray(x))

    port = PostProcess()
    p = params["params"]
    sd = {}
    for name in ("conv1", "conv2", "conv3"):
        sd[f"{name}.weight"] = p[name]["kernel"]
        sd[f"{name}.bias"] = p[name]["bias"]
    for i in range(6):
        for name in ("conv1", "conv2"):
            sd[f"resBlocks.{i}.{name}.weight"] = p[f"res{i}"][name]["kernel"]
            sd[f"resBlocks.{i}.{name}.bias"] = p[f"res{i}"][name]["bias"]
    port.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()},
                         strict=True)
    with torch.no_grad():
        got = port(torch.tensor(x)).numpy()
    assert float(np.max(np.abs(got - np.asarray(ref)))) < 1e-3


def test_packed_weights_cache_is_thread_safe():
    """Codec threads share PostProcess weights: however many threads ask
    for a weight's pack at once, it is packed once and counted once."""
    import sys
    import threading
    weights = [torch.randn(64, 64, 3, 3) for _ in range(40)]
    before = c3.packed_weights.packs
    barrier = threading.Barrier(16)
    results = [[] for _ in range(16)]

    def work(i):
        barrier.wait(timeout=30)
        for w in weights:
            results[i].append(c3.packed_weights(w, "wgmma").data_ptr())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert c3.packed_weights.packs - before == len(weights)
    assert all(r == results[0] for r in results) and len(results[0]) == 40
