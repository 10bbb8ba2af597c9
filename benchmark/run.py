"""The benchmark of the PyTorch and CUDA port (meshclust2_tpu_torch).

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Runs one cell of BENCHMARK.json on this machine's card and prints one JSON
line; harness/main.py says what a run does.
"""
import time

T0 = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

if __name__ == "__main__":
    from harness.main import main

    sys.exit(main(sys.argv[1:], T0))
