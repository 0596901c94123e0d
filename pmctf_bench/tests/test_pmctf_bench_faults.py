"""A run with the timed path broken underneath comes out not correct;
the sound run comes out correct. The harness's look for a card is
skipped (the CPU, a tiny model and tiny frames); everything else of a
run, its window, the reference and the check with the cell's own limits,
runs as on the card."""

import time

import pytest
import torch
from conftest import TINY_MODEL

from pmctf_bench import faults
from pmctf_bench.cells import load_cell, load_family
from pmctf_bench.harness import run

CELLS = ["pmctf_l_f32.estimate_gop16_1080p", "pmctf_l_f32.stream_gop4_1080p"]
STREAM = "pmctf_l_f32.stream_gop4_1080p"
# At 128x128 and the tiny widths the files' fixed costs weigh: the MV
# file is a 6-byte header on some 35 bytes, and the sound run's files
# read 1.49 above the reference's estimate, the doubled payload's 3.61.
# This rehearsal holds the files between the two; the cell's own limit
# is held at the cell's size on the card (test_pmctf_bench_card.py).
TINY_BITS_LIMIT = 2.5


def tiny(name):
    cell = load_cell(name)
    cell.config["model"].update(TINY_MODEL)
    cell.mix.update(gop=4, height=128, width=128)
    if name == STREAM:
        cell.limits["bits_gap"] = TINY_BITS_LIMIT
    return cell


def broken_run(name, fault):
    with faults.planted(fault) as break_port:
        return run(tiny(name), 2 ** 31 + 77, 0.5, False, torch.device("cpu"),
                   time.perf_counter(), break_port=break_port)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "altered"])
def test_broken_runs_are_not_correct(name, fault):
    result = broken_run(name, fault)
    assert result["correct"] is (fault is None), result["checks"]
    assert result["attempted"] >= 1
    assert list(result)[-1] == "checks"


def test_doubled_payload_is_not_correct():
    """Files that grow while every plane decodes equal: only the files'
    bits catch it."""
    result = broken_run(STREAM, "doubled_payload")
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["plane_rmse"]["value"] <= result["checks"]["plane_rmse"]["limit"]


def test_faults_are_undone():
    from learned_pmctf_tpu_torch import gop
    from learned_pmctf_tpu_torch.codec import image_codec, video_codec
    before = (image_codec.encode_image, video_codec.encode_p, gop.disable_tf32,
              torch.backends.cudnn.allow_tf32)
    for name in load_family("pmctf_l").GLOBAL_FAULTS:
        with faults.planted(name):
            pass
    assert before == (image_codec.encode_image, video_codec.encode_p, gop.disable_tf32,
                      torch.backends.cudnn.allow_tf32)
