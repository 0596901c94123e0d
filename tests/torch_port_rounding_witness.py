"""Where the unsharded port's planes leave the JAX package's on the slow
spatial test's stage (tests/test_torch_port_spatial_models.py::
test_sharded_stage_matches_jax; ROADMAP.md C.4), and why.

Runs JAX's jitted estimate_one_stage_multi on the test's weights and
noise frames, then the port's on the CPU in float32 and in float64,
recording every value the port rounds (torch.round). Prints each plane's
largest gap to JAX and how many values are off by more than 1e-3, then
the symbols whose float64 value lies nearest a half and, for each, the
gaps after the float32 port rounds that one symbol the other way. A
symbol whose flip brings a plane within 1e-3 of JAX everywhere is the
one that JAX's float32 sums put on the other side of the half.

    env JAX_PLATFORMS=cpu python tests/torch_port_rounding_witness.py [N]

N (default 12) symbols are tried; about 2 minutes on 4 CPU threads.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import test_torch_port_spatial_models as spatial  # noqa: E402
from torch_port_helpers import jax_small_model, jax_small_params  # noqa: E402

from learned_pmctf_tpu_torch.convert import params_from_jax  # noqa: E402
from learned_pmctf_tpu_torch.models.pmctf import empty_dpb  # noqa: E402

PLANES = ("L_t", "H_t", "L_tc", "H_tc")
_round = torch.round
_ctl = {"seen": None, "flip": None, "calls": 0}


def _recording_round(x, *args, **kwargs):
    """torch.round that records its inputs and, at one call and index,
    rounds to the other neighbour."""
    out = _round(x, *args, **kwargs)
    call = _ctl["calls"]
    _ctl["calls"] += 1
    if _ctl["seen"] is not None:
        _ctl["seen"].append(x.detach().clone())
    if _ctl["flip"] is not None and _ctl["flip"][0] == call:
        idx = _ctl["flip"][1]
        out = out.clone()
        out[idx] = torch.floor(x[idx]) + torch.ceil(x[idx]) - out[idx]
    return out


def jax_stage(params, ref, cur):
    import jax
    import jax.numpy as jnp
    from learned_pmctf_tpu.codec import PMCTFCodec as JaxCodec
    codec = JaxCodec(jax_small_model(**spatial.STAGE), jax.tree_util.tree_map(jnp.asarray, params))
    with jax.default_matmul_precision("highest"):
        out = codec.estimate_one_stage_multi(
            tuple(jnp.asarray(t.numpy()) for t in ref), tuple(jnp.asarray(t.numpy()) for t in cur),
            True, {"mv_feature": None, "ref_mv_y": None}, spatial.Q_LIST)
    return {k: np.asarray(out[k], np.float64) for k in PLANES}


def port_stage(state, ref, cur, dtype, flip=None, record=False):
    """The port's planes in `dtype` (the conv3x3 wrapper's plain version)
    and, with `record`, every value it rounded."""
    from learned_pmctf_tpu_torch.codec.video_codec import PMCTFCodec
    model = spatial.stage_model(state).to(dtype)
    for mod in model.modules():
        if hasattr(mod, "use_kernel"):
            mod.use_kernel = False
    _ctl.update(seen=[] if record else None, flip=flip, calls=0)
    with torch.no_grad(), PMCTFCodec(model, device="cpu") as codec:
        res = codec.estimate_one_stage_multi(
            tuple(t.to(dtype) for t in ref), tuple(t.to(dtype) for t in cur), True,
            empty_dpb(), spatial.Q_LIST)
    return {k: torch.as_tensor(res[k]).double().numpy() for k in PLANES}, _ctl["seen"]


def gaps(planes, want):
    """plane: (largest gap to JAX, values off by more than 1e-3, the rate
    points where they are)."""
    out = {}
    for k in PLANES:
        d = np.abs(planes[k] - want[k])
        off = d > 1e-3
        out[k] = (float(d.max()), int(off.sum()),
                  sorted({int(i) for i in np.nonzero(off)[0]}))
    return out


def main(n):
    torch.set_num_threads(4)
    torch.round = _recording_round
    params = jax_small_params(seed=6, **spatial.STAGE)
    state = params_from_jax(params)
    ref, cur = spatial.stage_frames()
    want = jax_stage(params, ref, cur)
    f32, seen32 = port_stage(state, ref, cur, torch.float32, record=True)
    f64, seen64 = port_stage(state, ref, cur, torch.float64, record=True)
    print("port f32 against JAX:", gaps(f32, want))
    print("port f64 against JAX:", gaps(f64, want))
    print("port f32 against port f64: largest gap",
          max(float(np.abs(f32[k] - f64[k]).max()) for k in PLANES))
    near = []
    for call, (a, b) in enumerate(zip(seen32, seen64)):
        dist = (b - torch.floor(b) - 0.5).abs()
        for idx in (dist < 2e-4).nonzero().tolist():
            idx = tuple(idx)
            near.append((float(dist[idx]), call, idx, float(a[idx]), float(b[idx])))
    near.sort()
    print(f"{len(near)} rounded values within 2e-4 of a half in float64; the nearest {n}:")
    for _, call, idx, v32, v64 in near[:n]:
        flipped, _ = port_stage(state, ref, cur, torch.float32, flip=(call, idx))
        print(f"round call {call} {tuple(seen32[call].shape)} at {idx}: f32 {v32:.9f}, "
              f"f64 {v64:.12f}; rounded the other way: {gaps(flipped, want)}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 12)
