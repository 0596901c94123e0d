"""Operations and bytes of one input (a GOP, a picture), counted from its shapes, and the peaks
of the card they are held against.

Every convolution (1x1, strided, depthwise and the sub-pixel convs'
included) counts 2 * C_in * C_out * kh * kw * H_out * W_out * N / groups
operations, once, whatever the implementation computes (a 3xTF32 split
makes three products of each, and they are not counted). Its bytes are
its input, its weights and its output, each read or written once, at the
configuration's precision. The model has no matmul outside its convs.
Elementwise work is not counted: a share of a roofline then reads low,
never high.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

# NVIDIA H100 SXM data sheet, dense (no sparsity), at 700 W
PEAK_FLOPS = {"f32": 495e12,   # TF32 tensor cores: the fastest f32 operands go
              "bf16": 989e12}
PEAK_BYTES = 3.35e12           # HBM3
BYTES = {"f32": 4, "bf16": 2}


def conv_ops(c_in: int, c_out: int, kh: int, kw: int, h_out: int, w_out: int,
             n: int, groups: int = 1) -> int:
    return 2 * c_in * c_out * kh * kw * h_out * w_out * n // groups


def conv_bytes(x_numel: int, w_numel: int, y_numel: int, precision: str) -> int:
    return (x_numel + w_numel + y_numel) * BYTES[precision]


class Work:
    """The operations, bytes and least time of the convs an input ran, by
    layer. `precision` is the configuration's ("f32" or "bf16")."""

    def __init__(self, precision: str):
        self.precision = precision
        self.ops: Dict[str, int] = defaultdict(int)
        self.bytes: Dict[str, int] = defaultdict(int)
        self.bound_s: Dict[str, float] = defaultdict(float)
        self.convs = 0

    def add_conv(self, layer: str, x, w, y, groups: int):
        n, c_in = x.shape[0], x.shape[1]
        c_out, _, kh, kw = w.shape
        ops = conv_ops(c_in, c_out, kh, kw, y.shape[2], y.shape[3], n, groups)
        nbytes = conv_bytes(x.numel(), w.numel(), y.numel(), self.precision)
        self.ops[layer] += ops
        self.bytes[layer] += nbytes
        self.bound_s[layer] += max(ops / PEAK_FLOPS[self.precision], nbytes / PEAK_BYTES)
        self.convs += 1

    def total_ops(self) -> int:
        return sum(self.ops.values())

    def ops_time_s(self) -> float:
        """The least time the peak allows for all counted operations."""
        return self.total_ops() / PEAK_FLOPS[self.precision]

    def summary(self) -> Dict:
        return {"precision": self.precision, "convs": self.convs,
                "ops": dict(self.ops), "bytes": dict(self.bytes),
                "bound_s": dict(self.bound_s)}
