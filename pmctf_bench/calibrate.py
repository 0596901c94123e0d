"""The readings that a cell's correctness limits are set from.

    python3 pmctf_bench/calibrate.py --workload <cell> --seeds 11 12 13 [--control] [--fault NAME]

For each seed, in one process, one run of the cell as ``harness.run``
makes it (set-up, warm-up, a window of one input, the plain reference on
the input the run samples), and with ``--control`` the reference put in
the port's place at the precision one step below the configuration's
(the config's ``control``: TF32 under f32, fp8 under bf16) on the same
input. With ``--fault`` the run's timed path is broken underneath by one
of the faults of the cell's family (``faults.py``). Prints one JSON line
a seed with every number of ``check.py`` for the port (the lower
reading, or a fault's) and the control (the upper), and the seconds the
run and the control took. The benchmark's own runs never run it;
pmctf_bench/tests/ keeps it as a test.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from pmctf_bench import faults  # noqa: E402
from pmctf_bench.cells import Cell, load_cell, load_family  # noqa: E402
from pmctf_bench.check import NUMBERS, gaps  # noqa: E402
from pmctf_bench.harness import _sync, run  # noqa: E402
from pmctf_bench.reference.model import Numerics  # noqa: E402


def readings(cell: Cell, seed: int, device, control: bool, fault=None) -> dict:
    """The port's numbers (and the control's) against the reference on
    the input a run of `seed` samples, the port broken by `fault` if given."""
    line = {"cell": cell.name, "seed": seed, "fault": fault}
    family = load_family(cell.family, cell.bench_dir)

    def after_check(kept, expect, reference, sample):
        line["port"] = {k: max(gaps(o, expect)[k] for o in kept) for k in NUMBERS}
        if control:
            family.attach(reference, Numerics(cell.config["control"]))
            t = time.perf_counter()
            low = family.reference_output(reference, sample, cell.mix)
            _sync(device)
            line.update(control=gaps(low, expect), control_precision=cell.config["control"],
                        control_s=time.perf_counter() - t)

    t = time.perf_counter()
    with faults.planted(fault, family) as break_port:
        result = run(cell, seed, 0.0, False, device, t, break_port=break_port,
                     after_check=after_check)
    line.update(correct=result["correct"], run_s=time.perf_counter() - t)
    return line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", help="one of the faults of the cell's family (faults.py)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for seed in args.seeds:
        line = readings(cell, seed, torch.device("cuda", 0), args.control, args.fault)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
