"""Device selection and f32 numerics shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.

    CUDA is the default; without a card this raises rather than carrying
    on quietly on the CPU. Callers that mean the CPU pass ``"cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def disable_tf32() -> None:
    """Keep convs and matmuls in full f32 for the rest of the process.

    cuDNN convs default to TF32 on Hopper, which keeps ~3 decimal digits
    and breaks f32 parity with the reference; the port's numerics assume
    f32 throughout."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def deterministic_cudnn() -> None:
    """Let cuDNN pick its convolution algorithm by shape alone, and only
    among deterministic ones, for the rest of the process.

    The bitstream codec needs it: the encoder replays the decoder's convs,
    and one ulp of difference between the two sides flips a rounded
    symbol or a table index and desyncs the range coder."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
