"""Vimeo-90k style dataset loaders (numpy and PIL, no torch).

A copy of learned_pmctf_tpu/data/vimeo.py: ``VideoFolder`` (single
frames of a septuplet list, the Y plane, 0..255) for the image coder and
``VideoYCbCr`` (N-frame clips, cropped alike across time, with the
curriculum hooks update_num_frames / update_interval /
use_random_interval / set_current_interval and the 4-frame id patterns)
for the video coder. Long clips (vimeo-32 style folders with >=
num_frames frames) serve the GOP-8/16 stages. The same files, seed and
calls give the same arrays as the JAX package's loaders, with one fix:
``update_num_frames`` ends the 4-frame id patterns, which the JAX copy
keeps on into the GOP-8 stage, where it raises.
"""

from __future__ import annotations

import glob
from pathlib import Path
from typing import List

import numpy as np
from PIL import Image


def _rgb_to_ycbcr_np(rgb):
    """JPEG-flavor RGB->YCbCr on (H, W, 3) float arrays, 0..255."""
    y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    cb = (rgb[..., 2] - y) * 0.564 + 128.0
    cr = (rgb[..., 0] - y) * 0.713 + 128.0
    return np.stack([y, cb, cr], axis=-1)


def _rgb_to_ycocg_np(rgb):
    """Lossless YCoCg on integer arrays."""
    x = rgb.astype(np.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    co = r - b
    tmp = b + (co >> 1)
    cg = g - tmp
    y = tmp + (cg >> 1)
    return np.stack([y, co, cg], axis=-1).astype(np.float32)


def _load_rgb(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"), dtype=np.float32)


def _random_crop(frames: List[np.ndarray], size, rng):
    h, w = frames[0].shape[:2]
    ph, pw = size
    top = int(rng.integers(0, h - ph + 1))
    left = int(rng.integers(0, w - pw + 1))
    return [f[top:top + ph, left:left + pw] for f in frames]


def _center_crop(frames: List[np.ndarray], size):
    h, w = frames[0].shape[:2]
    ph, pw = size
    top = (h - ph) // 2
    left = (w - pw) // 2
    return [f[top:top + ph, left:left + pw] for f in frames]


class VideoFolder:
    """Single-frame (image coder) loader over Vimeo septuplet lists.

    Returns (1, ph, pw) float32 Y planes in 0..255.
    """

    def __init__(self, root, split: str = "train", patch_size=(256, 256),
                 tuplet: int = 7, rnd_interval: bool = False, seed: int = 0):
        prefix = {3: "tri", 7: "sep"}[tuplet]
        suffix = {"train": "trainlist", "valid": "testlist",
                  "test": "testlist"}[split]
        list_path = Path(root) / f"{prefix}_{suffix}.txt"
        if not list_path.is_file():
            raise RuntimeError(f'invalid list file "{list_path}"')
        with open(list_path) as f:
            self.sample_folders = [
                Path(root) / "sequences" / line.strip()
                for line in f
                if line.strip() and (Path(root) / "sequences" / line.strip()).is_dir()
            ]
        if split == "valid":
            self.sample_folders = self.sample_folders[:100]
        self.patch_size = patch_size
        self.split = split
        self.rnd_interval = rnd_interval
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.sample_folders)

    def __getitem__(self, index):
        folder = self.sample_folders[index]
        samples = sorted(p for p in folder.iterdir() if p.is_file())
        pick = samples[int(self._rng.integers(0, len(samples)))] \
            if self.split == "train" else samples[0]
        rgb = _load_rgb(pick)
        y = _rgb_to_ycbcr_np(rgb)[..., 0:1]
        if self.split == "train":
            (y,) = _random_crop([y], self.patch_size, self._rng)
        else:
            (y,) = _center_crop([y], self.patch_size)
        return np.ascontiguousarray(y.transpose(2, 0, 1))  # (1, ph, pw)


class VideoYCbCr:
    """N-frame video loader with curriculum hooks.

    Returns a tuple of num_frames (3, ph, pw) float32 YCbCr (or lossless
    YCoCg) frames, 0..255, cropped consistently across time.
    """

    def __init__(self, root, split: str = "train", num_frames: int = 2,
                 patch_size=(128, 128), rnd_interval: bool = False,
                 lossless: bool = False, seed: int = 0):
        self.sample_folders = sorted(
            glob.iglob(str(Path(root) / "sequences") + "/*/*/"))
        if split == "valid":
            self.sample_folders = self.sample_folders[:10]
        self.split = split
        self.patch_size = patch_size
        self.num_frames = num_frames
        self.num_frames_max = num_frames
        self.rnd_interval = rnd_interval
        self.lossless = lossless
        self.max_interval = 1
        self.current_interval = 1
        self.use_idx_list = False
        self.frame_ids_curr = None
        self._rng = np.random.default_rng(seed)

    # ---- curriculum hooks (ref: video.py:59-109) --------------------------------

    def update_num_frames(self, num_frames: int, logger=None):
        if logger:
            logger.info(f"num_frames: {self.num_frames} -> {num_frames}")
        self.num_frames = num_frames
        self.num_frames_max = num_frames
        # the 4-frame id patterns end with their stage: kept on (as the
        # JAX package keeps them), a GOP-8 stage after the GOP-4 one
        # would read 4 frames and raise; use_random_interval turns them
        # on again for a 4-frame stage
        self.use_idx_list = False
        self.frame_ids_curr = None

    def update_interval(self, max_interval: int, logger=None):
        if logger:
            logger.info(f"max_interval: {self.max_interval} -> {max_interval}")
        self.max_interval = max_interval
        self.rnd_interval = max_interval > 1

    def use_random_interval(self):
        self.rnd_interval = True
        if self.num_frames == 4:
            self.use_idx_list = True

    def set_current_interval(self):
        if self.use_idx_list:
            return self.get_frame_ids()
        self.current_interval = int(self._rng.integers(1, self.max_interval + 1))
        return self.current_interval

    def get_frame_ids(self):
        """Hand-crafted 4-frame patterns. ref: video.py:95-109."""
        choice = self._rng.random()
        if choice < 0.2:
            self.frame_ids_curr = [0, 2, 4, 6]
            return 2
        if choice < 0.4:
            self.frame_ids_curr = [0, 1, 3, 5]
            return 2
        start = int(self._rng.integers(0, 4))
        self.frame_ids_curr = [start + i for i in range(4)]
        return 1

    # -----------------------------------------------------------------------------

    def __len__(self):
        return len(self.sample_folders)

    def __getitem__(self, index):
        folder = Path(self.sample_folders[index])
        samples = sorted(p for p in folder.iterdir() if p.is_file())
        if self.use_idx_list and self.frame_ids_curr is not None:
            frame_paths = [samples[i] for i in self.frame_ids_curr]
        else:
            interval = self.current_interval if self.rnd_interval \
                else self.max_interval
            if self.current_interval == 4 and self.num_frames >= 3:
                frame_paths = [samples[0], samples[4], samples[6]]
            else:
                frame_paths = (samples[::interval])[:self.num_frames]
        if len(frame_paths) < self.num_frames:
            raise RuntimeError(
                f"{folder} has {len(samples)} frames; need {self.num_frames} "
                f"at interval {self.current_interval} (use a long-clip "
                f"dataset, e.g. vimeo-32, for GOP 8/16 stages)")

        frames = [_load_rgb(p) for p in frame_paths]
        if self.split == "train":
            frames = _random_crop(frames, self.patch_size, self._rng)
        else:
            frames = _center_crop(frames, self.patch_size)
        conv = _rgb_to_ycocg_np if self.lossless else _rgb_to_ycbcr_np
        return tuple(
            np.ascontiguousarray(conv(f).transpose(2, 0, 1)) for f in frames)
