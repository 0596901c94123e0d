"""On the card, at each cell's own size: the control fails the cell's
limits while the port passes them; a port left in TF32 fails the f32
cells (the reference keeps its own f32); files that grow fail the stream
cell; and a short run of each cell comes out correct. Each test skips
without a card.

    python3 -m pytest pmctf_bench/tests -q -m cuda
"""

import time

import pytest

from pmctf_bench.calibrate import readings
from pmctf_bench.cells import load_cell
from pmctf_bench.harness import run

CELLS = ["pmctf_l_f32.estimate_gop16_1080p", "pmctf_l_bf16.estimate_gop8_2160p",
         "pmctf_l_f32.stream_gop4_1080p"]
F32_CELLS = [c for c in CELLS if load_cell(c).config["precision"] == "f32"]


def _over(numbers, limits):
    return [k for k in limits if k in numbers and numbers[k] > limits[k]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name, card):
    cell = load_cell(name)
    line = readings(cell, 2 ** 31 + 919, card, control=True)
    assert line["correct"] and not _over(line["port"], cell.limits), line
    assert _over(line["control"], cell.limits), line


@pytest.mark.cuda
@pytest.mark.parametrize("name", F32_CELLS)
def test_port_left_in_tf32_is_not_correct(name, card):
    cell = load_cell(name)
    line = readings(cell, 2 ** 31 + 921, card, control=False, fault="tf32")
    assert not line["correct"] and _over(line["port"], cell.limits), line


@pytest.mark.cuda
def test_doubled_payload_is_not_correct(card):
    cell = load_cell("pmctf_l_f32.stream_gop4_1080p")
    line = readings(cell, 2 ** 31 + 922, card, control=False, fault="doubled_payload")
    assert not line["correct"] and _over(line["port"], cell.limits) == ["bits_gap"], line


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(name, card):
    result = run(load_cell(name), 2 ** 31 + 920, 1.0, False, card, time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
