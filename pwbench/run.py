"""Runs one cell of the benchmark once and prints its result line.

    python3 pwbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cells, metrics and bounds are in
``BENCHMARK.json``; everything a cell is made of is under ``pwbench/``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches at fixed paths inside the checkout (the program
# builds its own kernels into .torch_ext_build/ there).
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = os.path.join(ROOT, ".pwbench_cache", sub)
sys.path.insert(0, ROOT)

from pwbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    try:
        code = main(sys.argv[1:], t_start=T_START)
    except Exception:
        import traceback

        traceback.print_exc()
        code = 1
    sys.exit(code)
