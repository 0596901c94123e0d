"""The plain reference against the port at a tiny size on the CPU, and
the controls against the port."""

import pytest
import torch
from conftest import TINY_MODEL

from learned_pmctf_tpu_torch.gop import code_gop
from learned_pmctf_tpu_torch.models.pmctf import PMCTF
from pmctf_bench.check import gaps
from pmctf_bench.frames import smooth_moving
from pmctf_bench.reference.gop import code_gop as reference_gop
from pmctf_bench.reference.model import PMCTF as ReferencePMCTF, Numerics
from pmctf_bench.weights import make_state

SEED = 2 ** 31 + 101


def build(warp, act_bf16=False, seed=SEED):
    cfg = dict(TINY_MODEL, warp_mode=warp)
    with torch.device("meta"):
        ref = ReferencePMCTF(**cfg)
        port = PMCTF(**cfg, act_bf16=act_bf16)
    state = make_state(ref, seed, "cpu")
    ref = ref.to_empty(device="cpu")
    ref.load_state_dict(state)
    port = port.to_empty(device="cpu")
    port.load_state_dict(state)
    return port.eval(), ref.attach(Numerics("f32")).eval()


@pytest.mark.parametrize("warp", ["exact", "fast"])
def test_reference_is_the_port_on_the_cpu(warp):
    """On the CPU the port's PostProcess runs its plain convs: the two
    agree to the bit on every rate and plane."""
    port, ref = build(warp)
    luma, chroma = smooth_moving(4, 64, 128, "cpu", SEED)
    a = code_gop(port, luma, chroma, 10.0, device="cpu")
    b = reference_gop(ref, luma, chroma, 10.0)
    assert a["bits"] == b["bits"]
    for x, y in zip(a["luma"] + a["chroma"], b["luma"] + b["chroma"]):
        assert torch.equal(x, y)


def test_state_dict_names_are_the_ports():
    port, ref = build("exact")
    ps, rs = port.state_dict(), ref.state_dict()
    assert set(ps) == set(rs) and all(ps[k].shape == rs[k].shape for k in ps)


def test_reference_rejects_what_it_does_not_code():
    with torch.device("meta"), pytest.raises(ValueError):
        ReferencePMCTF(**TINY_MODEL, ll_mode="ar")


@pytest.mark.parametrize("warp, act_bf16, control", [("exact", False, "tf32"),
                                                      ("fast", True, "fp8")])
def test_control_reads_above_the_port(warp, act_bf16, control):
    """The control (the reference one precision step below the
    configuration's) lies farther from the reference than the port does,
    on every number, at this size too."""
    port, ref = build(warp, act_bf16)
    luma, chroma = smooth_moving(4, 64, 128, "cpu", SEED + 1)
    expect = reference_gop(ref, luma, chroma, 10.0)
    program = gaps(code_gop(port, luma, chroma, 10.0, device="cpu"), expect)
    ref.attach(Numerics(control))
    low = gaps(reference_gop(ref, luma, chroma, 10.0), expect)
    for k in low:
        assert low[k] > 2 * program[k], (k, low, program)
