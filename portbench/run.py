"""Run one cell of BENCHMARK.json on the CUDA card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON line (see `bench.py`); exits non-zero without it when
the card is missing or JAX was loaded."""
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(t0=T0))
