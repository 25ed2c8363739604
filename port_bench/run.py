"""The benchmark of ``ecs_yolo_tpu_torch`` on the card: one run of one cell.

    python port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Loads the cell named in ``BENCHMARK.json``
(its files under ``port_bench/``), sets up, warms up, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line as the last line of standard output:
with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the profiler's busy and window seconds and a breakdown.
Exits non-zero, printing no result, without a CUDA card (or with fewer than
the cell asks for), and if JAX or the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process with few threads: the host's share of a served batch (the
# forward's issue, NMS's walk) is what its host noise moves
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "2")

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opt = ap.parse_args(argv)
    if not (ROOT / "ecs_yolo_tpu_torch").is_dir():
        print("port_bench: no ecs_yolo_tpu_torch beside port_bench: nothing to measure",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from port_bench.core import runner

    runner.STARTED = STARTED
    return runner.run(opt.workload, opt.seed, opt.seconds, bool(opt.trace), ROOT)


if __name__ == "__main__":
    sys.exit(main())
