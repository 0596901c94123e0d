"""Port parity, width-sharded spatial parallelism (parallel/halo.py) end
to end on the CPU: the sharded port against the unsharded port, which the
other port tests hold against the JAX package, at the tolerances of the
JAX tests each case mirrors (tests/test_parallel.py):

- LiftingScheme2D.forward_lift_2d on a 2 x 2 (data x spatial) mesh at
  4x1x256x512, and back through backward_lift_2d: atol 5e-5, rtol 1e-5;
- PWave(decomp_levels=2, features=8, ar_features=8, ll_mode="fourstep")
  on the 2 x 2 mesh at 4x1x128x256: x_hat atol 2e-3, bpp rel 1e-4;
- one full pMCTF stage (PMCTFCodec.estimate_one_stage_multi, Q = 4 at
  q 0, 7, 14, 20, luma 64x128, chroma 2x32x64) on the 2 x 2 mesh and on
  a 1 x 2 mesh, where a second stage reads the first one's DPB and
  inverse_mctf_multi undoes both: bits rtol 1e-5 and atol 1e-4, planes
  atol 1e-3.

The ranks are gloo ranks in one subprocess (this file run as a script),
one thread each, under a timeout; each rank builds the same seeded
model and codes its block (its rows of the batch or rate points, its
columns of the frame). The case against the JAX package's unsharded
estimate_one_stage_multi on weights carried across by
convert.params_from_jax is marked slow (its planes are held where the
unsharded port rounds its symbols as JAX does: see its docstring).
"""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from learned_pmctf_tpu_torch.parallel import halo, mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE = dict(decomp_levels=2, num_me_stages=1, channel_mv=8, channel_n=8, features=8,
             ar_features=8, spynet_levels=3)
Q_LIST = [0, 7, 14, 20]
LIFT_ATOL, LIFT_RTOL = 5e-5, 1e-5
PWAVE_ATOL, PWAVE_BPP_REL = 2e-3, 1e-4
BITS_RTOL, BITS_ATOL, PLANE_ATOL = 1e-5, 1e-4, 1e-3
MESHES = {"2x2": (4, 2), "1x2": (2, 2)}  # name: (ranks, spatial)


def with_biases(model, seed):
    """`model` with every bias drawn (the seeded init zeroes them), so
    that the zero padding at a shard's inner edge would show."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return model


def lifting_model():
    from learned_pmctf_tpu_torch.models.layers import init_params
    from learned_pmctf_tpu_torch.models.wavelet import LiftingScheme2D
    m = init_params(LiftingScheme2D(), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # P/U nets of some weight: their halo matters
        for name, p in m.named_parameters():
            if p.dim() == 4 and p.shape[-2:] == (3, 3):
                p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    return with_biases(m, 2)


def lifting_frame():
    return torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 1, 256, 512)).astype(np.float32))


def pwave_model():
    from learned_pmctf_tpu_torch.models.layers import init_params
    from learned_pmctf_tpu_torch.models.pwave import PWave
    m = PWave(decomp_levels=2, features=8, ar_features=8, ll_mode="fourstep")
    return with_biases(init_params(m, torch.Generator().manual_seed(0)), 3).eval()


def pwave_frame():
    return torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (4, 1, 128, 256)).astype(np.float32))


def stage_model(state=None):
    from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
    model = with_biases(build_pmctf("cpu", seed=1, **STAGE), 4)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model


def stage_frames():
    """((ref y, ref chroma), (cur y, cur chroma)), each tiled over Q as
    the JAX test tiles them: (Q, 1, 1, 64, 128) and (Q, 2, 1, 32, 64)."""
    g = np.random.default_rng(7)
    y0, y1 = (g.integers(0, 256, (1, 1, 64, 128)) for _ in range(2))
    c0, c1 = (g.integers(0, 256, (2, 1, 32, 64)) for _ in range(2))

    def tile(a):
        return torch.from_numpy(a.astype(np.float32))[None].repeat(4, 1, 1, 1, 1)
    return (tile(y0), tile(c0)), (tile(y1), tile(c1))


def block(t, rows, cols):
    """A rank's block: its rows of axis 0 and its columns."""
    return t[rows][..., cols].contiguous()


def stages(model, ref, cur, q, two):
    """One stage (and with `two` a second reading its DPB, then
    inverse_mctf_multi of both); planes and bits."""
    from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
    from learned_pmctf_tpu_torch.models.pmctf import empty_dpb
    keys = ("L_t", "H_t", "L_tc", "H_tc", "bit_L", "bit_H", "bit_ME")
    out = {}
    with PMCTFCodec(model, device="cpu") as codec:
        first = codec.estimate_one_stage_multi(ref, cur, True, empty_dpb(), q)
        out.update({k: first[k] for k in keys})
        if two:
            second = codec.estimate_one_stage_multi(cur, ref, True, first["dpb"], q)
            out.update({f"second_{k}": second[k] for k in keys})
            for tag, res in (("", first), ("second_", second)):
                y = codec.inverse_mctf_multi(res["L_t"], res["H_t"], res["mv_hat"])
                c = codec.inverse_mctf_multi(res["L_tc"], res["H_tc"], res["mv_hat"],
                                             downscale=True)
                out.update({f"{tag}inv_ref": y[0], f"{tag}inv_cur": y[1],
                            f"{tag}inv_ref_c": c[0], f"{tag}inv_cur_c": c[1]})
    return {k: torch.as_tensor(v) for k, v in out.items()}


def run_cases(name, shard=None, state=None):
    """The cases of mesh `name` on one process (shard None) or on this
    rank's block (shard: its mesh)."""
    out = {}
    rows = lambda n: (slice(None) if shard is None  # noqa: E731
                      else mesh.data_rows(n, shard.data_index, shard.data_size))

    def cols(w, align=1):
        return (slice(None) if shard is None
                else mesh.frame_columns(w, shard.spatial_index, shard.spatial, align))

    def scope():
        return halo.spatial_shard(shard) if shard is not None else contextlib.nullcontext()

    with torch.no_grad():
        if name == "2x2":
            m, x = lifting_model(), block(lifting_frame(), rows(4), cols(512))
            with scope():
                sb = m.forward_lift_2d(x)
                out["lift"] = {k: v.contiguous() for k, v in sb.items()}
                out["lift_back"] = m.backward_lift_2d(sb)
            m, x = pwave_model(), block(pwave_frame(), rows(4), cols(256, 8))
            with scope():
                res = m(x, 10.0)
            out["pwave"] = {"x_hat": res["x_hat"], "bpp_total": res["bpp_total"],
                            "bits": res["bits"]}
        model = stage_model(state)
        (ry, rc), (cy, cc) = stage_frames()
        q_rows = rows(4)
        ref = (block(ry, q_rows, cols(128, model.spatial_align())),
               block(rc, q_rows, cols(64)))
        cur = (block(cy, q_rows, cols(128)), block(cc, q_rows, cols(64)))
        halo.counters(reset=True)
        with scope():
            out["stage"] = stages(model, ref, cur, Q_LIST[q_rows], name == "1x2")
        out["exchanges"] = halo.counters()
    return out


def _rank(out_dir, name, spatial, state_path):
    torch.set_num_threads(1)
    shard = mesh.make_mesh(spatial=spatial, device="cpu")
    state = torch.load(state_path) if state_path else None
    torch.save({"mesh": (shard.data_index, shard.data_size, shard.spatial_index,
                         shard.spatial), **run_cases(name, shard, state)},
               os.path.join(out_dir, f"{name}_{shard.rank}.pt"))


def start_ranks(tmp_path, names=tuple(MESHES), state=None):
    """The meshes' ranks in a subprocess (this file as a script);
    finish_ranks waits for it."""
    state_path = ""
    if state is not None:
        state_path = str(tmp_path / "state.pt")
        torch.save(state, state_path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(tmp_path),
                             ",".join(names), state_path], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp_path, names


def finish_ranks(started, timeout=600):
    proc, out, names = started
    try:
        text, _ = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, text[-5000:]
    return {name: [torch.load(out / f"{name}_{r}.pt") for r in range(MESHES[name][0])]
            for name in names}


def assemble(ranks, get, dim_rows=0):
    """The whole tensor from the ranks' blocks: columns of a row of the
    grid side by side, the rows stacked; `get` picks a rank's block."""
    spatial = ranks[0]["mesh"][3]
    grid = [ranks[i:i + spatial] for i in range(0, len(ranks), spatial)]
    return torch.cat([torch.cat([get(r) for r in row], dim=-1) for row in grid], dim=dim_rows)


def per_row(ranks, get):
    """A per-element quantity every rank of a grid row holds alike (the
    rates): the rows' values stacked, after checking the row agrees."""
    spatial = ranks[0]["mesh"][3]
    out = []
    for i in range(0, len(ranks), spatial):
        row = [get(r) for r in ranks[i:i + spatial]]
        for other in row[1:]:
            assert torch.equal(other, row[0])
        out.append(row[0])
    return torch.cat(out)


def assert_stage(ranks, want):
    """Every rate and plane the ranks returned against `want`'s."""
    for k in ranks[0]["stage"]:
        if "bit_" in k:
            got = per_row(ranks, lambda r: r["stage"][k].reshape(-1))
            np.testing.assert_allclose(got.numpy(), want[k].numpy(), rtol=BITS_RTOL,
                                       atol=BITS_ATOL, err_msg=k)
        else:
            got = assemble(ranks, lambda r: r["stage"][k])
            np.testing.assert_allclose(got.numpy(), want[k].numpy(), atol=PLANE_ATOL,
                                       rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both meshes' ranks, started once for the module while the tests
    compute the unsharded references."""
    torch.set_num_threads(2)
    started = start_ranks(tmp_path_factory.mktemp("spatial"))
    got = {}

    def wait():
        if not got:
            got.update(finish_ranks(started))
        return got
    return wait


@pytest.fixture(scope="module")
def unsharded():
    """The unsharded stages both meshes are held to: two stages and the
    inverses (the 2 x 2 mesh's one stage is the first of them)."""
    with torch.no_grad():
        return stages(stage_model(), *stage_frames(), Q_LIST, True)


def test_sharded_lifting_matches_unsharded(ranks):
    """forward_lift_2d on the 2 x 2 mesh: every subband (and the row
    pass's l, h) equals the unsharded lifting, and backward_lift_2d of
    the sharded subbands the unsharded inverse."""
    m = lifting_model()
    with torch.no_grad():
        want = m.forward_lift_2d(lifting_frame())
        back = m.backward_lift_2d(want)
    got = ranks()["2x2"]
    for k, v in want.items():
        np.testing.assert_allclose(assemble(got, lambda r: r["lift"][k]).numpy(), v.numpy(),
                                   atol=LIFT_ATOL, rtol=LIFT_RTOL, err_msg=k)
    np.testing.assert_allclose(assemble(got, lambda r: r["lift_back"]).numpy(), back.numpy(),
                               atol=LIFT_ATOL, rtol=LIFT_RTOL)
    np.testing.assert_allclose(back.numpy(), lifting_frame().numpy(), atol=1e-3)


def test_sharded_pwave_matches_unsharded(ranks):
    """PWave.forward (lifting pyramid, LSTM context, four-step priors,
    synthesis, PostProcess) on the 2 x 2 mesh: x_hat, the per-sample
    bits (the frame's on every rank of a row) and bpp_total."""
    m = pwave_model()
    with torch.no_grad():
        want = m(pwave_frame(), 10.0)
    got = ranks()["2x2"]
    np.testing.assert_allclose(assemble(got, lambda r: r["pwave"]["x_hat"]).numpy(),
                               want["x_hat"].numpy(), atol=PWAVE_ATOL, rtol=0)
    bits = per_row(got, lambda r: r["pwave"]["bits"])
    np.testing.assert_allclose(bits.numpy(), want["bits"].numpy(), rtol=PWAVE_BPP_REL)
    # each row of the grid holds half the batch: its bpp over its samples
    for r in got:
        rows = mesh.data_rows(4, r["mesh"][0], r["mesh"][1])
        np.testing.assert_allclose(float(r["pwave"]["bpp_total"]),
                                   float(want["bits"][rows].sum()) / (2 * 128 * 256),
                                   rtol=PWAVE_BPP_REL)


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_stage_matches_unsharded(ranks, unsharded, name):
    """estimate_one_stage_multi with Q over "data" and the width over
    "spatial" against the unsharded batch: on 2 x 2 one stage, on 1 x 2
    a second stage on the first one's DPB (the MV encoder's context and
    the prior's reference latent, sharded too) and inverse_mctf_multi of
    both; the exchanges were counted."""
    got = ranks()[name]
    assert len(got[0]["stage"]) == (7 if name == "2x2" else 22)
    assert_stage(got, unsharded)
    for r in got:
        assert r["exchanges"]["exchanges"] > 100 and r["exchanges"]["bytes"] > 0


@pytest.mark.slow  # the JAX stage eagerly: about a minute
def test_sharded_stage_matches_jax(tmp_path):
    """The 1 x 2 mesh's first stage on weights drawn for the JAX model and
    carried across (convert.params_from_jax) against the JAX package's
    unsharded estimate_one_stage_multi: bits rtol 1e-5 and atol 1e-4;
    planes atol 1e-3 wherever the unsharded port rounds as JAX does. On
    these noise frames two quantized symbols lie within 2e-6 of a half,
    and JAX's f32 sums put them on the other side of it from the port's,
    in f32 and in f64 alike (tests/torch_port_rounding_witness.py: each
    flipped alone brings its plane within 2.6e-4 of JAX everywhere). The
    unsharded port's planes differ from JAX's by up to 7.2 around them
    (its bits by 2e-6 relative); there the sharded port must give the
    unsharded port's planes, and the footprint stays under 1% of a
    plane (0.93% measured)."""
    import jax
    import jax.numpy as jnp
    from learned_pmctf_tpu.codec import PMCTFCodec as JaxCodec
    from learned_pmctf_tpu_torch.convert import params_from_jax
    from torch_port_helpers import jax_small_model, jax_small_params
    torch.set_num_threads(2)
    params = jax_small_params(seed=6, **STAGE)
    state = params_from_jax(params)
    started = start_ranks(tmp_path, ("1x2",), state)
    (ry, rc), (cy, cc) = stage_frames()
    codec = JaxCodec(jax_small_model(**STAGE), jax.tree_util.tree_map(jnp.asarray, params))
    with jax.default_matmul_precision("highest"):
        want = codec.estimate_one_stage_multi(
            (jnp.asarray(ry.numpy()), jnp.asarray(rc.numpy())),
            (jnp.asarray(cy.numpy()), jnp.asarray(cc.numpy())), True,
            {"mv_feature": None, "ref_mv_y": None}, Q_LIST)
    unsharded = run_cases("1x2", state=state)["stage"]
    got = finish_ranks(started)["1x2"]
    assert_stage(got, unsharded)
    flipped = {}
    for k in ("L_t", "H_t", "L_tc", "H_tc", "bit_L", "bit_H", "bit_ME"):
        jax_k = np.array(want[k])
        if k.startswith("bit"):
            got_k = per_row(got, lambda r: r["stage"][k].reshape(-1)).numpy()
            np.testing.assert_allclose(got_k, jax_k, rtol=BITS_RTOL, atol=BITS_ATOL,
                                       err_msg=k)
            continue
        got_k = assemble(got, lambda r: r["stage"][k]).numpy()
        same = np.abs(unsharded[k].numpy() - jax_k) <= PLANE_ATOL
        np.testing.assert_allclose(got_k[same], jax_k[same], atol=PLANE_ATOL, rtol=0,
                                   err_msg=k)
        flipped[k] = (int((~same).sum()), same.size,
                      float(np.abs(unsharded[k].numpy() - jax_k).max()))
    assert all(n <= 0.01 * size for n, size, _ in flipped.values()), flipped


if __name__ == "__main__":
    # the ranks of start_ranks: out dir, the meshes' names, the initial
    # state ("" for the seeded one)
    for mesh_name in sys.argv[2].split(","):
        n, s = MESHES[mesh_name]
        mesh.spawn(_rank, n, (sys.argv[1], mesh_name, s, sys.argv[3]), device="cpu")
