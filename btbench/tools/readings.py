"""The readings the check's limits are set from, on the card, in one
process: for each program seed a short run of the cell (its compared
numbers), and for each control seed the control's numbers.

    python3 btbench/tools/readings.py --workload NAME --seconds S \
        --seeds 1,2,... --control-seeds 101,102,...

Prints one JSON line per seed.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from btbench.harness import spec as specs  # noqa: E402
from btbench.harness.control import control_numbers  # noqa: E402
from btbench.harness.main import run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    a = ap.parse_args(argv)
    sp = specs.load_spec(a.workload)
    for s in filter(None, a.seeds.split(",")):
        out, report = run_cell(sp, int(s), a.seconds, False,
                               device="cuda")
        print(json.dumps(dict(side="program", seed=int(s),
                              correct=out["correct"],
                              attempted=out["attempted"],
                              numbers={k: v["value"] for k, v in
                                       out["check"].items()},
                              notes=[r for r in report
                                     if r.startswith("fault")])),
              flush=True)
    for s in filter(None, a.control_seeds.split(",")):
        print(json.dumps(dict(side="control", seed=int(s),
                              numbers=control_numbers(sp, int(s)))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
