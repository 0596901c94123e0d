"""Faults planted under the timed path, for the checks that a broken run
comes out not correct (pmctf_bench/tests/ and ``calibrate.py --fault``).

``planted(name)`` is a context manager: inside it the fault is in place,
and it yields the ``break_port`` function that ``harness.run`` applies
to the port's model (None where the fault is planted elsewhere).
Nothing of the port's files changes; everything is undone on leaving.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch


def unchanged(model):
    """The inverse temporal step returns its state unchanged."""
    model.inverse_mctf = lambda l_t, h_t, *a, **k: (l_t, h_t)


def half_batch(model):
    """Half of the batch (chroma's V plane) left out: the step runs on the
    rest and stands it in for the whole."""
    inverse = model.inverse_mctf

    def broken(l_t, h_t, *a, **k):
        if l_t.shape[0] < 2:
            return inverse(l_t, h_t, *a, **k)
        half = l_t.shape[0] // 2
        ref, cur = inverse(l_t[:half], h_t[:half], *a, **k)
        return ref.repeat(2, 1, 1, 1), cur.repeat(2, 1, 1, 1)
    model.inverse_mctf = broken


def altered(model):
    """One decoded plane altered where it is produced: a 16x16 block of
    the first frame pair's luma off by two levels, once a GOP-4's inverse
    ladder."""
    inverse, calls = model.inverse_mctf, []

    def broken(l_t, h_t, *a, **k):
        ref, cur = inverse(l_t, h_t, *a, **k)
        calls.append(1)
        if len(calls) % 4 == 0:
            cur = cur.clone()
            cur[..., :16, :16] += 2.0
        return ref, cur
    model.inverse_mctf = broken


MODEL_FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}


@contextlib.contextmanager
def _doubled_payload() -> Iterator[None]:
    """Every stream file carries its payload twice, as from a writer that
    flushes twice: the header's length counts one copy and decoding reads
    only that, so every plane still decodes equal to the encoder side,
    and the written files grow."""
    from learned_pmctf_tpu_torch.codec import image_codec, video_codec
    write_image, write_p = image_codec.encode_image, video_codec.encode_p

    def doubled_image(height, width, num_channels, bit_stream, output):
        write_image(height, width, num_channels, bit_stream, output)
        with open(output, "ab") as f:
            f.write(bit_stream)

    def doubled_p(string, mv_y_q_index, output):
        write_p(string, mv_y_q_index, output)
        with open(output, "ab") as f:
            f.write(string)
    image_codec.encode_image, video_codec.encode_p = doubled_image, doubled_p
    try:
        yield
    finally:
        image_codec.encode_image, video_codec.encode_p = write_image, write_p


@contextlib.contextmanager
def _tf32() -> Iterator[None]:
    """The port leaves TF32 on: its calls that turn it off turn it on."""
    from learned_pmctf_tpu_torch import gop
    from learned_pmctf_tpu_torch.codec import image_codec
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    before = [f.allow_tf32 for f in flags]
    calls = (gop.disable_tf32, image_codec.disable_tf32)

    def tf32_on():
        for f in flags:
            f.allow_tf32 = True
    gop.disable_tf32 = image_codec.disable_tf32 = tf32_on
    tf32_on()
    try:
        yield
    finally:
        gop.disable_tf32, image_codec.disable_tf32 = calls
        for f, b in zip(flags, before):
            f.allow_tf32 = b


GLOBAL_FAULTS = {"doubled_payload": _doubled_payload, "tf32": _tf32}
NAMES = tuple(MODEL_FAULTS) + tuple(GLOBAL_FAULTS)


@contextlib.contextmanager
def planted(name: Optional[str]) -> Iterator[Optional[Callable]]:
    """Plant fault `name` (None: none) for the duration of the block."""
    if name is None:
        yield None
    elif name in MODEL_FAULTS:
        yield MODEL_FAULTS[name]
    elif name in GLOBAL_FAULTS:
        with GLOBAL_FAULTS[name]():
            yield None
    else:
        raise KeyError(f"no fault {name!r}; faults: {NAMES}")
