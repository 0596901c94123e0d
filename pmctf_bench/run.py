"""Run one cell of the benchmark once and print its result line.

    python3 pmctf_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python3 -m pmctf_bench.run ...`` too). It
needs a CUDA card and exits with code 2 without one. The build and kernel
caches stay in fixed directories inside the checkout: the port's own
(``learned_pmctf_tpu_torch/build/``) and, for what PyTorch and Triton
would compile, ``.bench_cache/``.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from pmctf_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
