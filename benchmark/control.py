"""Readings for the limits of a cell's check: the program's numbers and
the control's (the reference at the precision below the configuration's,
fp8 for its bfloat16, put in the program's place) on several seeds, in one
process.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 3

Prints one JSON line a seed: ``checks`` (the program's numbers) and
``control_checks`` (the control's), each beside the cell's limit, and
``readings``, every number the check works out, compared or not.
``--fault <name>`` (``yardstick/faults.py``) plants that fault under the
program's timed path instead, and ``checks`` are the faulty run's.  Runs
on the card; without one it exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    from benchmark.yardstick.faults import FAULTS
    fault = FAULTS[args.fault] if args.fault else None
    run._cache_env()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    bench = run.load_bench()
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(bench, args.workload, seed, args.seconds, 0,
                           control=True, fault=fault)
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": res["correct"],
                          "control_correct": res["control_correct"],
                          "checks": res["checks"],
                          "control_checks": res["control_checks"],
                          "readings": res["readings"],
                          "metrics": res["metrics"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
