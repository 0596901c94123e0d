"""Port parity, the spatial mesh and its halo exchanges on the CPU
(parallel/mesh.py make_mesh(spatial=S), frame_columns; parallel/halo.py),
mirroring tests/test_parallel.py:19-33 (the JAX mesh and shardings):

- 8 gloo ranks with spatial 2 form a 4 x 2 (data x spatial) grid in rank
  order, each rank in one row group and one column group;
- frame_columns covers a frame's width in rank order and raises, naming
  the alignment, when a block does not divide by it;
- on a spatial axis of 4 ranks widen, gather_width, own_columns,
  sum_over_width, mean_over_width and halo_call give exactly the slices
  of the whole tensor: halos narrower and wider than a neighbour's block,
  none beyond a frame edge, outputs cropped at two resolutions; so does
  the fast warp; a pMCTF stage on blocks of no multiple of its alignment
  raises;
- every sub-network's declared halo covers its reach: changing the
  columns beyond it leaves the cropped interior unchanged, bit for bit
  (float64, drawn weights and biases);
- outside a shard every helper is the identity.

The ranks run in one subprocess (this file as a script), one thread
each, under a timeout.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from learned_pmctf_tpu_torch.ops.warp import flow_warp_fast
from learned_pmctf_tpu_torch.parallel import halo, mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 8
BLOCK = 6  # columns a rank of the spatial axis of 4


def whole():
    """The tensor the four ranks of a row hold blocks of: (2, 3, 5, 24)."""
    g = torch.Generator().manual_seed(0)
    return torch.randn(2, 3, 5, 4 * BLOCK, generator=g, dtype=torch.float64)


def _halves(a, b):
    """A function of two resolutions with a reach of one column: a 3-tap
    sum of `a` and the 2x average pool of `a` plus `b` (half width)."""
    pad = torch.nn.functional.pad(a, (1, 1))
    return pad[..., :-2] + pad[..., 1:-1] + pad[..., 2:], \
        torch.nn.functional.avg_pool2d(a, (1, 2)) + b


def _helpers(shard):
    """The helpers on this rank's block of whole() (spatial axis of 4)."""
    x = whole()
    cols = mesh.frame_columns(4 * BLOCK, shard.spatial_index, 4)
    xb = x[..., cols].contiguous()
    half = x[..., ::2].contiguous()
    hb = half[..., mesh.frame_columns(2 * BLOCK, shard.spatial_index, 4)].contiguous()
    out = {}
    halo.counters(reset=True)
    with halo.spatial_shard(shard):
        for left, right in ((2, 3), (9, 13), (24, 1)):
            out[f"widen_{left}_{right}"] = halo.widen(xb, left, right)
        out["widen_dim2"] = halo.widen(xb.transpose(2, 3), 4, 4, dim=2)
        out["gather"] = halo.gather_width(xb)
        out["own"] = halo.own_columns(x)
        out["sum"] = halo.sum_over_width(xb.sum(dim=(1, 2, 3)))
        out["mean"] = halo.mean_over_width(xb)
        out["halves"] = halo.halo_call(_halves, xb, hb, r=1)
        out["columns"] = halo.global_width(hb)
    with halo.spatial_shard(shard):
        try:
            from learned_pmctf_tpu_torch.models.pmctf import build_pmctf
            model = build_pmctf("cpu", seed=0, decomp_levels=2, num_me_stages=1,
                                channel_mv=8, channel_n=8, features=8, ar_features=8,
                                spynet_levels=2)
            z = torch.zeros(1, 1, 64, 32)  # a block of 32 columns
            with torch.no_grad():
                model.forward_one_stage(z, z, 10.0, True, {"mv_feature": None,
                                                          "ref_mv_y": None})
            out["misaligned"] = "no error"
        except ValueError as e:
            out["misaligned"] = str(e)
    out["counters"] = halo.counters()
    flow = _flow()
    with halo.spatial_shard(shard):
        for d in (3, 7):  # halos of 4 and of 8 columns, wider than a block
            out[f"fast_warp_{d}"] = flow_warp_fast(xb, flow[..., cols].contiguous(), d)
    return out


def _flow():
    g = torch.Generator().manual_seed(1)
    return torch.randn(2, 2, 5, 4 * BLOCK, generator=g, dtype=torch.float64) * 4


def _rank(out_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    grid = mesh.make_mesh(spatial=2, device="cpu")
    me = torch.tensor([float(grid.rank)])
    row, col = me.clone(), me.clone()
    dist.all_reduce(row, group=grid.spatial_group)
    dist.all_reduce(col, group=grid.data_group)
    got = {"grid": (grid.data_index, grid.data_size, grid.spatial_index, grid.spatial),
           "row_sum": float(row), "col_sum": float(col)}
    got.update(_helpers(mesh.make_mesh(spatial=4, device="cpu")))
    torch.save(got, f"{out_path}.{grid.rank}")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("spatial") / "rank"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        text, _ = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, text[-5000:]
    return [torch.load(f"{out}.{r}") for r in range(RANKS)]


def test_mesh_of_eight_ranks_is_four_by_two(ranks):
    """make_mesh(spatial=2) on 8 ranks: data 4 x spatial 2, rank r at
    (r // 2, r % 2), its row group the two ranks of its row, its column
    group the four of its column."""
    for r, got in enumerate(ranks):
        assert got["grid"] == (r // 2, 4, r % 2, 2)
        assert got["row_sum"] == sum(range(2 * (r // 2), 2 * (r // 2) + 2))
        assert got["col_sum"] == sum(range(r % 2, RANKS, 2))


def test_frame_columns_cover_the_width_and_check_the_alignment():
    """frame_columns splits the width as P(..., "spatial"): contiguous
    blocks in rank order; a block that does not divide by the alignment
    raises and names it; one rank outside a group is not a spatial mesh."""
    assert [mesh.frame_columns(1920, s, 2, 64) for s in range(2)] == [
        slice(0, 960), slice(960, 1920)]
    x = np.arange(128)
    assert np.array_equal(np.concatenate([x[mesh.frame_columns(128, s, 4)]
                                          for s in range(4)]), x)
    with pytest.raises(ValueError, match="alignment 64"):
        mesh.frame_columns(1920, 0, 4, 64)  # 480 columns a block
    with pytest.raises(ValueError, match="alignment 1"):
        mesh.frame_columns(130, 0, 4)
    with pytest.raises(ValueError, match="does not divide over a spatial axis of 2"):
        mesh.make_mesh(spatial=2, device="cpu")


def test_exchange_helpers_on_four_ranks(ranks):
    """On each row of a 2 x 4 grid: widen equals the slice of the whole
    tensor (a halo within the neighbour, one wider than it, one as wide
    as the frame; none beyond an edge; along dim 2 too), gather_width the
    whole tensor, own_columns the block, sum_over_width and
    mean_over_width the whole's, halo_call the unsharded function's
    blocks at both of its resolutions; a misaligned stage raises; the
    fast warp (its halo of max_disp + 1, its clamp at the frame's edges)
    gives the unsharded warp's block, bit for bit."""
    x = whole()
    full, pooled = _halves(x, x[..., ::2])
    for got in ranks:
        s = got["grid"][0] % 2 * 2 + got["grid"][2]  # index on the spatial axis of 4
        lo, hi = s * BLOCK, (s + 1) * BLOCK
        for left, right in ((2, 3), (9, 13), (24, 1)):
            want = x[..., max(0, lo - left):min(4 * BLOCK, hi + right)]
            assert torch.equal(got[f"widen_{left}_{right}"], want), (s, left, right)
        assert torch.equal(got["widen_dim2"],
                           x[..., max(0, lo - 4):min(4 * BLOCK, hi + 4)].transpose(2, 3))
        assert torch.equal(got["gather"], x)
        assert torch.equal(got["own"], x[..., lo:hi])
        torch.testing.assert_close(got["sum"], x.sum(dim=(1, 2, 3)))
        torch.testing.assert_close(got["mean"], x.mean())
        assert torch.equal(got["halves"][0], full[..., lo:hi])
        assert torch.equal(got["halves"][1], pooled[..., lo // 2:hi // 2])
        assert got["columns"] == 2 * BLOCK
        assert "does not divide by 64" in got["misaligned"], got["misaligned"]
        for d in (3, 7):
            assert torch.equal(got[f"fast_warp_{d}"], flow_warp_fast(x, _flow(), d)[..., lo:hi])
        # 3 + 1 widens, a gather, a sum, a mean, a halo_call; the stage's
        # check comes before any exchange
        assert got["counters"]["exchanges"] == 8 and got["counters"]["bytes"] > 0


def _perturbed_beyond(xs, a, b, r, w0, g):
    """xs with every column farther than r from the window [a, b) (in
    columns of a width-w0 input) redrawn."""
    out = []
    for x in xs:
        if x is None:
            out.append(None)
            continue
        k = x.shape[-1] / w0
        y = x.clone()
        lo, hi = math.floor((a - r) * k), math.ceil((b + r) * k)
        y[..., :max(lo, 0)] = torch.randn(y[..., :max(lo, 0)].shape, generator=g,
                                          dtype=y.dtype)
        y[..., hi:] = torch.randn(y[..., hi:].shape, generator=g, dtype=y.dtype)
        out.append(y)
    return out


def _flat(o):
    if o is None:
        return []
    if torch.is_tensor(o):
        return [o]
    return [t for i in o for t in _flat(i)]


def test_declared_halos_cover_each_subnetwork():
    """For every width-coupled sub-network, redrawing the input columns
    beyond its declared halo (in columns of its first input; the other
    inputs' scaled) leaves every output on the window unchanged, bit for
    bit: float64, weights and biases drawn."""
    from learned_pmctf_tpu_torch.models import context, mv_coder, pmctf, postprocess, wavelet
    from learned_pmctf_tpu_torch.models.context import ContextFusionSubband
    from learned_pmctf_tpu_torch.ops.resample import bilinear_downsample
    from learned_pmctf_tpu_torch.ops.warp import flow_warp_fast
    torch.set_num_threads(2)
    m = pmctf.build_pmctf("cpu", seed=1, decomp_levels=2, num_me_stages=1, channel_mv=8,
                          channel_n=8, features=8, ar_features=8, spynet_levels=2).double()
    ar = ContextFusionSubband(1, 8).double()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in list(m.parameters()) + list(ar.parameters()):
            p.add_(torch.randn(p.shape, generator=g, dtype=p.dtype) * 0.1)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    pw, lift, tf = m.hp_coder, m.hp_coder.wavelet_transform.lift_h, m.temporal_filtering[0]
    pw.dequantModule.use_kernel = False  # the plain convs take float64
    ctx, fus = pw.context_prediction, pw.context_fusion[0]["lh"]

    def lstm(up):
        return lambda sb, *t: ctx._step(sb, ((t[0], t[1]), (t[2], t[3]), (t[4], t[5])), up)
    states = [rnd(1, 32, 4, 64)] * 4 + [rnd(1, 3, 4, 64)] * 2
    cases = {  # name: (fn, inputs, declared halo, window)
        "row lifting step": (lambda s: lift._increment_local(s, lift.conv_P1, lift.P_1),
                             [rnd(1, 1, 4, 64)], wavelet.PU_RADIUS, (24, 40)),
        "column lifting step": (
            lambda s: lift._increment_local(s.transpose(2, 3), lift.conv_U2,
                                            lift.U_2).transpose(2, 3),
            [rnd(1, 1, 4, 64)], wavelet.PU_RADIUS + 1, (24, 40)),
        "temporal filter": (tf.P_t, [rnd(1, 1, 4, 64)], wavelet.PU_RADIUS, (24, 40)),
        "LSTM step": (lstm(None), [rnd(1, 1, 4, 64)] + states, context.LSTM_RADIUS,
                      (24, 40)),
        "LSTM step, upsampling": (lstm(0), [rnd(1, 1, 4, 64)] + states,
                                  context.LSTM_RADIUS + 1, (24, 40)),
        "hierarchical prior": (fus.hier_params, [rnd(1, 1, 4, 64), rnd(1, 1, 2, 32),
                                                 rnd(1, 1, 4, 64)], context.HIER_RADIUS,
                               (24, 40)),
        "prior pass": (lambda a, f: fus.spatial_params(a, f, 1),
                       [rnd(1, 1, 4, 64), rnd(1, 8, 4, 64)], context.PASS_RADIUS, (24, 40)),
        "AR net": (ar, [rnd(1, 1, 4, 64)], context.AR_RADIUS, (24, 40)),
        "PostProcess": (pw.dequantModule, [rnd(1, 1, 4, 80)], postprocess.HALO, (32, 48)),
        "MV encoder and hyper-encoder": (
            lambda f, c: (lambda y: (y, m.mv_hyper_prior_encoder[0](y)))(
                m.mv_encoder[0](f, c, 1.3)),
            [rnd(1, 2, 64, 512), rnd(1, 8, 16, 128)], pmctf.MV_ENC_HALO, (192, 320)),
        "hyper-decoder and prior fusion": (
            lambda z, r: m._prior_params(z, r, 0), [rnd(1, 8, 2, 16), rnd(1, 8, 8, 64)],
            pmctf.MV_PRIOR_HALO, (6, 10)),
        "MV prior pass": (
            lambda a, c: m.mv_y_spatial_prior[0](m._adaptors(0)[1](torch.cat([a, c], 1))),
            [rnd(1, 8, 4, 32), rnd(1, 24, 4, 32)], mv_coder.PASS_RADIUS, (12, 20)),
        "MV decoder": (lambda y: m.mv_decoder[0](y, 1.1), [rnd(1, 8, 4, 32)],
                       pmctf.MV_DEC_HALO, (12, 20)),
        "chroma MV downsample": (bilinear_downsample, [rnd(1, 2, 4, 64)],
                                 pmctf.MV_DOWN_HALO, (24, 40)),
        "fast warp": (lambda f, fl: flow_warp_fast(f, fl, 6),
                      [rnd(1, 1, 8, 64), rnd(1, 2, 8, 64) * 8], 6 + 1, (24, 40)),
    }
    with torch.no_grad():
        for name, (fn, xs, r, (a, b)) in cases.items():
            w0 = xs[0].shape[-1]
            assert a - r >= 0 and b + r <= w0, name
            want = _flat(fn(*xs))
            got = _flat(fn(*_perturbed_beyond(xs, a, b, r, w0, g)))
            wider = _flat(fn(*_perturbed_beyond(xs, a, b, 0, w0, g)))
            for o, p, q in zip(want, got, wider):
                k = o.shape[-1] / w0
                window = slice(int(a * k), int(b * k))
                assert torch.equal(o[..., window], p[..., window]), name
                # the window does depend on the columns next to it
                assert not torch.equal(o[..., window], q[..., window]), name


def test_helpers_are_the_identity_outside_a_shard():
    """No scope (or a spatial axis of one rank): every helper returns its
    input, halo_call calls the function as it is."""
    x = whole()
    one = mesh.make_mesh(device="cpu")
    assert (one.spatial, one.data_index, one.data_size, one.spatial_index) == (1, 0, 1, 0)
    with halo.spatial_shard(one) as shard:
        assert shard is None and halo.current() is None
        assert halo.widen(x, 3, 3) is x and halo.gather_width(x) is x
        assert halo.own_columns(x) is x and halo.sum_over_width(x) is x
        assert halo.global_width(x) == x.shape[-1]
        assert torch.equal(halo.mean_over_width(x), x.mean())
        for got, want in zip(halo.halo_call(_halves, x, x[..., ::2], r=1),
                             _halves(x, x[..., ::2])):
            assert torch.equal(got, want)


if __name__ == "__main__":
    mesh.spawn(_rank, RANKS, (sys.argv[1],), device="cpu")
