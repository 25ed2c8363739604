"""Readings that set a cell's limits: the program's numbers and the
precision control's on many seeds, in one process.

    python port_bench/control.py --workload <cell> --seeds 1,2,3 [--seconds 2] [--faults-on 3]

For each seed: the cell's set-up and a short window as ``run.py`` runs
them, then the check's numbers for the program, and the same numbers for
the control -- the plain reference computed in the precision below the
configuration's (fp8 for bf16), put in the program's place -- and, where
the traffic plants them, for each fault (``fault.<name>``; on the first
``--faults-on`` seeds).  Prints one
JSON line a seed.  A limit lies between the program's largest reading and
the smallest reading that must fail (``PERF.md`` gives both).  The
benchmark's own runs never run the control.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(workload: str, seeds, seconds: float, device=None, overrides=None, out=None,
             faults_on: int = None):
    import torch

    from port_bench.core import runner, spec

    out = out or sys.stdout
    runner.cache_dirs(ROOT)
    rows = []
    for i, seed in enumerate(seeds):
        ctx = runner.context(workload, seed, seconds, False, ROOT, device, overrides)
        traffic = spec.load_module("traffic", ctx.mix["kind"], ROOT)
        t0 = time.perf_counter()
        st = traffic.setup(ctx)
        setup_s = time.perf_counter() - t0
        res = traffic.measure(ctx, st)
        traffic.release(ctx, st)
        gc.collect()
        row = {"workload": workload, "seed": seed, "setup_s": setup_s, "e2e": res["e2e"],
               "program": traffic.check(ctx, st),
               **traffic.control(ctx, st, faults=faults_on is None or i < faults_on)}
        del st
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), file=out, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults-on", type=int, default=None,
                    help="read the planted faults on the first N seeds only")
    opt = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from port_bench.core import card

    try:
        card.require(1)
    except card.NoCard as e:
        print(f"control: {e}", file=sys.stderr)
        return 2
    readings(opt.workload, [int(s) for s in opt.seeds.split(",")], opt.seconds,
             faults_on=opt.faults_on)
    return 0


if __name__ == "__main__":
    sys.exit(main())
