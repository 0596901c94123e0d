"""Port parity, ops layer: learned_pmctf_tpu_torch.ops / entropy against
the JAX package's functions on the same numpy inputs (CPU, f32; the
resampling and lifting helpers in test_torch_port_ops_2.py); and the
rules every port test file keeps: no import of JAX in the port, entry
points that refuse to run without CUDA, at most eight tests a file."""

import ast
import pathlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from learned_pmctf_tpu.ops import quant as jquant
from learned_pmctf_tpu.ops import warp as jwarp
from learned_pmctf_tpu.entropy import distributions as jdist

from learned_pmctf_tpu_torch.ops import quant, warp
from learned_pmctf_tpu_torch.entropy import distributions

ATOL = 1e-4
PORT = pathlib.Path(__file__).resolve().parent.parent / "learned_pmctf_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def _numerics():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(2)
    yield
    jax.config.update("jax_default_matmul_precision", old)


def _close(port, ref, atol=ATOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), rtol=0, atol=atol)


def test_flow_warp_matches_jax():
    g = np.random.default_rng(0)
    feat = g.normal(0, 1, (2, 3, 32, 40)).astype(np.float32)
    flow = g.normal(0, 6, (2, 2, 32, 40)).astype(np.float32)
    _close(warp.flow_warp(torch.tensor(feat), torch.tensor(flow)),
           jwarp.flow_warp(jnp.asarray(feat), jnp.asarray(flow)))


def test_laplace_bits_matches_jax():
    g = np.random.default_rng(3)
    y = np.round(g.normal(0, 4, (2, 3, 16, 16))).astype(np.float32)
    scale = np.abs(g.normal(0, 3, y.shape)).astype(np.float32)
    scale[0, 0, 0, :4] = 0.0  # exercises the 1e-5 clip
    _close(distributions.laplace_bits(torch.tensor(y), torch.tensor(scale)),
           jdist.laplace_bits(jnp.asarray(y), jnp.asarray(scale)))


def test_ste_ops_match_jax_values_and_grads():
    g = np.random.default_rng(4)
    x = g.normal(0, 3, (64,)).astype(np.float32)
    x[:4] = [0.5, 1.5, -2.5, 2.5]  # halves round to even in both
    tx = torch.tensor(x, requires_grad=True)
    _close(quant.ste_round(tx), jquant.ste_round(jnp.asarray(x)), atol=0)
    _close(quant.ste_clamp(tx, -1.0, 2.0),
           jquant.ste_clamp(jnp.asarray(x), -1.0, 2.0), atol=0)
    (quant.ste_round(tx) * 3.0).sum().backward()
    _close(tx.grad, np.full_like(x, 3.0), atol=0)


def test_lower_bound_grad_rule_matches_jax():
    g = np.random.default_rng(5)
    x = g.normal(0.5, 1.0, (128,)).astype(np.float32)
    up = g.normal(0, 1.0, (128,)).astype(np.float32)
    tx = torch.tensor(x, requires_grad=True)
    y = quant.lower_bound(tx, 0.5)
    (y * torch.tensor(up)).sum().backward()
    jy, vjp = jax.vjp(lambda a: jquant.lower_bound(a, 0.5), jnp.asarray(x))
    _close(y, jy, atol=0)
    _close(tx.grad, vjp(jnp.asarray(up))[0], atol=0)


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


FORBIDDEN = ("jax", "jaxlib", "flax", "learned_pmctf_tpu")


def _jax_imports(files):
    """(file, module) of every import of JAX, flax or the JAX package,
    at module level or inside a function."""
    return [(f, mod) for f in files for mod in _imported_modules(f)
            if mod.split(".")[0] in FORBIDDEN]


def test_port_imports_nothing_of_jax():
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    assert len(files) > 10
    scanned = {f.relative_to(PORT).as_posix() for f in files if PORT in f.parents}
    assert {"parallel/__init__.py", "parallel/mesh.py", "utils/bdrate.py",
            "utils/visualizer.py", "cli/average_flow.py"} <= scanned
    assert not _jax_imports(files)


def test_import_scan_catches_a_planted_jax_import(tmp_path):
    """The scan above on a copy of the package: clean as it is, and each
    import planted into a copied module (at its top, or inside a
    function) is reported."""
    import shutil
    copy = tmp_path / "pkg"
    shutil.copytree(PORT, copy, ignore=shutil.ignore_patterns("build", "csrc", "__pycache__"))
    assert not _jax_imports(sorted(copy.rglob("*.py")))
    plants = {"parallel/mesh.py": ("import jax\n", "jax"),
              "utils/bdrate.py": ("from learned_pmctf_tpu.utils import bdrate\n",
                                  "learned_pmctf_tpu.utils"),
              "utils/visualizer.py": ("\n\ndef _planted():\n    import flax.linen as nn\n",
                                      "flax.linen"),
              "cli/average_flow.py": ("import jax.numpy as jnp\n", "jax.numpy")}
    for rel, (line, _) in plants.items():
        f = copy / rel
        text = f.read_text()
        f.write_text(text + line if line.startswith("\n") else line + text)
    found = {(f.relative_to(copy).as_posix(), mod)
             for f, mod in _jax_imports(sorted(copy.rglob("*.py")))}
    assert found == {(rel, mod) for rel, (_, mod) in plants.items()}


def test_entry_points_refuse_to_run_without_cuda(monkeypatch):
    from learned_pmctf_tpu_torch.codec.image_codec import PWaveCodec
    from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
    from learned_pmctf_tpu_torch.gop import code_gop, stream_gop
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    model = build_pmctf("cpu", decomp_levels=2, num_me_stages=1, channel_mv=8,
                        channel_n=8, features=8, ar_features=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_pmctf(decomp_levels=2, num_me_stages=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        code_gop(None, [], [], 10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PMCTFCodec(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PWaveCodec(model.hp_coder)
    with PMCTFCodec(model, device="cpu") as codec:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            stream_gop(codec, [], [], 10, "unused")
    from learned_pmctf_tpu_torch.cli import average_flow, flex, train_pmctf
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flex.main(["--synthetic", "4", "--synthetic_size", "64x64"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flex.main(["--synthetic", "4", "--q_index_num", "2", "--q_batch", "--shard_q"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_pmctf.main(["-d", "unused", "--data_parallel", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        average_flow.main(["--data", "unused"])


MAX_TESTS_A_FILE = 8


def test_port_test_files_stay_small():
    """No tests/test_torch_port_*.py file collects more than eight tests
    outside `slow`: pytest-xdist's --dist loadfile hands out the files
    with the most tests first, and tests/test_parallel.py (eight tests,
    the suite's longest file) must start among the first files, or the
    tier-1 run outlasts its clock."""
    import collections
    import os
    import subprocess
    import sys
    tests = pathlib.Path(__file__).resolve().parent
    files = sorted(str(p.relative_to(tests.parent)) for p in tests.glob("test_torch_port_*.py"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-m", "not slow",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "no:xdist", *files],
        cwd=tests.parent, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    counts = collections.Counter(line.split("::")[0] for line in run.stdout.splitlines()
                                 if "::" in line)
    assert len(counts) > 30, counts
    too_many = {f: n for f, n in counts.items() if n > MAX_TESTS_A_FILE}
    assert not too_many, too_many
