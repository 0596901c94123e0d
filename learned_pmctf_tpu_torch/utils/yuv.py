"""Planar YUV 4:2:0 file IO (numpy).

Counterpart of learned_pmctf_tpu/utils/yuv.py; the same bytes.
"""

from __future__ import annotations

import os

import numpy as np


def read_yuv_frame(path: str, width: int, height: int, poc: int = 0,
                   bitdepth=np.uint8):
    """Read one 4:2:0 frame (Y, Cb, Cr) at picture order count `poc`."""
    bytes_per_sample = 2 if bitdepth in (np.uint16, np.int16) else 1
    frame_bytes = int(width * height * 1.5 * bytes_per_sample)
    with open(path, "rb") as f:
        f.seek(frame_bytes * poc)
        y = np.fromfile(f, dtype=bitdepth, count=width * height)
        y = y.reshape(height, width)
        cw, ch = width // 2, height // 2
        cb = np.fromfile(f, dtype=bitdepth, count=cw * ch).reshape(ch, cw)
        cr = np.fromfile(f, dtype=bitdepth, count=cw * ch).reshape(ch, cw)
    return y, cb, cr


def write_yuv_frame(path: str, y, cb, cr, append: bool = True):
    mode = "ab" if append else "wb"
    with open(path, mode) as f:
        for plane in (y, cb, cr):
            np.asarray(plane).tofile(f)


class YUVReader:
    """Sequential 4:2:0 frame reader with seek-by-POC."""

    def __init__(self, src_file: str, width: int, height: int,
                 start_index: int = 0):
        if not os.path.exists(src_file):
            raise FileNotFoundError(src_file)
        self.src_file = src_file
        self.width = width
        self.height = height
        self.current_frame_index = start_index
        self.eof = False

    def read_one_frame(self):
        if self.eof:
            return None, None, None
        y, cb, cr = read_yuv_frame(
            self.src_file, self.width, self.height, self.current_frame_index)
        self.current_frame_index += 1
        return y, cb, cr

    def close(self):
        self.current_frame_index = 0


class YUVWriter:
    """Sequential 4:2:0 frame writer: the first frame truncates the file."""

    def __init__(self, dst_file: str):
        self.dst_file = dst_file
        self._first = True

    def write_one_frame(self, y, cb, cr):
        write_yuv_frame(self.dst_file, y, cb, cr, append=not self._first)
        self._first = False
