"""Bitstream container formats (struct-packed headers) and padding.

Counterpart of learned_pmctf_tpu/utils/stream.py, the functions the
codecs and the eval CLI use; the bytes are the same as the JAX package's
(and the reference's) containers.
"""

from __future__ import annotations

import struct
from pathlib import Path


def get_padding_size(height: int, width: int, p: int = 64):
    """(left, right, top, bottom) zero padding to multiples of p; pads
    right and bottom only."""
    new_h = (height + p - 1) // p * p
    new_w = (width + p - 1) // p * p
    return 0, new_w - width, 0, new_h - height


def get_downsampled_shape(height: int, width: int, p: int):
    """Shape of a latent downsampled by p from a plane padded to p."""
    new_h = (height + p - 1) // p * p
    new_w = (width + p - 1) // p * p
    return int(new_h / p + 0.5), int(new_w / p + 0.5)


def encode_image(height: int, width: int, num_channels: int,
                 bit_stream: bytes, output: str):
    """(H, W, C, len) u32 header + payload."""
    with Path(output).open("wb") as f:
        f.write(struct.pack(">4I", height, width, num_channels, len(bit_stream)))
        f.write(bit_stream)


def decode_image(inputpath: str):
    with Path(inputpath).open("rb") as f:
        height, width, num_channels, length = struct.unpack(">4I", f.read(16))
        bit_stream = f.read(length)
    if len(bit_stream) != length:
        raise ValueError(f"{inputpath}: {len(bit_stream)} of {length} bytes")
    return height, width, num_channels, bit_stream


def encode_p(string: bytes, mv_y_q_index: int, output: str):
    """MV stream: u16 q index + u32 len + payload."""
    with Path(output).open("wb") as f:
        f.write(struct.pack(">H", mv_y_q_index))
        f.write(struct.pack(">I", len(string)))
        f.write(string)


def decode_p(inputpath: str):
    with Path(inputpath).open("rb") as f:
        (mv_y_q_index,) = struct.unpack(">H", f.read(2))
        (length,) = struct.unpack(">I", f.read(4))
        string = f.read(length)
    if len(string) != length:
        raise ValueError(f"{inputpath}: {len(string)} of {length} bytes")
    return mv_y_q_index, string
