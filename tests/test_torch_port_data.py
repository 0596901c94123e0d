"""Port parity, data: the port's copies of the Vimeo loaders and the
threaded loader give the same arrays as the JAX package's from the same
seed, on a temporary folder of PNGs that PIL writes (grey, RGB and RGBA
files, so each of PIL's conversions to RGB is read).

The PNG decoder is PIL's on both sides: the machine with the card has
PIL too, so the port carries no reader of its own.
"""

import os

import numpy as np
import pytest
from PIL import Image

from learned_pmctf_tpu.data import DataLoader as JaxDataLoader
from learned_pmctf_tpu.data import VideoFolder as JaxVideoFolder
from learned_pmctf_tpu.data import VideoYCbCr as JaxVideoYCbCr

from learned_pmctf_tpu_torch.data.loader import DataLoader
from learned_pmctf_tpu_torch.data.vimeo import VideoFolder, VideoYCbCr
from learned_pmctf_tpu_torch.training.curriculum import CurriculumConfig

MODES = ("RGB", "L", "RGBA")


def write_vimeo_pngs(root, sequences=3, frames=32, h=72, w=88, seed=0):
    """A Vimeo-layout folder: sequences/00001/NNNN/im{1..frames}.png (a
    textured picture moving by (1, 2) px a frame), plus sep_trainlist.txt
    and sep_testlist.txt naming every sequence. Sequence i is written in
    PIL mode MODES[i % 3]. Returns the sequence names."""
    g = np.random.default_rng(seed)
    names = []
    for s in range(sequences):
        name = f"00001/{s + 1:04d}"
        d = os.path.join(root, "sequences", name)
        os.makedirs(d)
        base = g.integers(0, 256, (h + frames, w + 2 * frames, 4)).astype(np.uint8)
        for t in range(frames):
            px = base[t:t + h, 2 * t:2 * t + w]
            mode = MODES[s % len(MODES)]
            img = {"RGB": px[..., :3], "L": px[..., 0], "RGBA": px}[mode]
            Image.fromarray(img, mode).save(os.path.join(d, f"im{t + 1}.png"))
        names.append(name)
    for f in ("sep_trainlist.txt", "sep_testlist.txt"):
        with open(os.path.join(root, f), "w") as fh:
            fh.write("\n".join(names) + "\n")
    return names


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("vimeo"))
    write_vimeo_pngs(d)
    return d


def _equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("split", ["train", "valid"])
def test_video_folder_matches_jax(root, split):
    kw = dict(split=split, patch_size=(32, 48), seed=3)
    port, ref = VideoFolder(root, **kw), JaxVideoFolder(root, **kw)
    assert len(port) == len(ref) == 3
    for _ in range(2):
        for i in range(len(ref)):
            _equal(port[i], ref[i])


def drive(ds, cfg, stages, items):
    """Replay the calls the trainer (cli/train_pmctf.py, as the JAX
    package's train_pmctf.py) makes on its dataset through `stages` of
    the curriculum `cfg`, two batches' worth an epoch; returns what
    ``items(ds)`` read after every interval draw."""
    out = []
    for s in stages:
        ds.update_num_frames(cfg.num_frames[s])
        if cfg.frame_interval[s] > 1:
            ds.update_interval(cfg.frame_interval[s])
        if s >= 4 and cfg.parts[s] == "All":
            ds.use_random_interval()
        if s >= 3:
            ds.use_random_interval()
            out.append(ds.set_current_interval())
        for _ in range(2):
            out.append(items(ds))
            if s >= 3:
                out.append(ds.set_current_interval())
    return out


def test_video_ycbcr_curriculum_matches_jax(root):
    """Stages 1-6 of configs/train_mctf_gop16.json (GOP 4, 4, 2, 2, 2,
    4; the 4-frame id patterns from stage 6) through every curriculum
    hook, in the trainer's order; YCbCr and lossless YCoCg."""
    cfg = CurriculumConfig.from_json("configs/train_mctf_gop16.json")

    def items(ds):
        return [ds[i] for i in range(len(ds))]

    for lossless in (False, True):
        kw = dict(split="train", num_frames=cfg.num_frames[0],
                  patch_size=(32, 32), lossless=lossless, seed=5)
        got = drive(VideoYCbCr(root, **kw), cfg, range(6), items)
        want = drive(JaxVideoYCbCr(root, **kw), cfg, range(6), items)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if isinstance(b, int):
                assert a == b
            else:
                for x, y in zip(a, b):
                    _equal(x, y)


def test_video_ycbcr_goes_on_from_the_gop4_patterns_to_gop8(root):
    """The fault the port fixes: after stage 6's 4-frame id patterns the
    JAX copy reads 4 frames at the GOP-8 stage and raises; the port reads
    8, then 16 (at interval 1 or 2: 32-frame clips, as vimeo-32's)."""
    cfg = CurriculumConfig.from_json("configs/train_mctf_gop16.json")
    kw = dict(split="train", num_frames=cfg.num_frames[0], patch_size=(32, 32),
              seed=5)
    shapes = drive(VideoYCbCr(root, **kw), cfg, range(8),
                   lambda ds: [tuple(f.shape for f in ds[0])])
    assert [len(s[0]) for s in shapes if isinstance(s, list)][-4:] == [8, 8, 16, 16]
    with pytest.raises(RuntimeError, match="need 8"):
        drive(JaxVideoYCbCr(root, **kw), cfg, range(8), lambda ds: ds[0])


def test_video_ycbcr_valid_center_crop_matches_jax(root):
    kw = dict(split="valid", num_frames=2, patch_size=(40, 24))
    port, ref = VideoYCbCr(root, **kw), JaxVideoYCbCr(root, **kw)
    for i in range(len(ref)):
        _equal(port[i], ref[i])


@pytest.mark.parametrize("drop_last", [True, False])
def test_data_loader_matches_jax(root, drop_last):
    kw = dict(num_frames=2, patch_size=(16, 16), seed=7)
    mk = dict(batch_size=2, num_workers=1, seed=11, drop_last=drop_last)
    port = DataLoader(VideoYCbCr(root, **kw), **mk)
    ref = JaxDataLoader(JaxVideoYCbCr(root, **kw), **mk)
    assert len(port) == len(ref) == (1 if drop_last else 2)
    for _ in range(2):  # two epochs: the shuffles continue alike
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(ref)
        for a, b in zip(got, want):
            _equal(a, b)


def test_video_ycbcr_refuses_a_too_short_clip(root):
    ds = VideoYCbCr(root, num_frames=33)
    with pytest.raises(RuntimeError, match="has 32 frames"):
        ds[0]
