"""What a run reads, found by name: BENCHMARK.json's cell and metrics,
and under btbench/ the configuration, the traffic mix, the metric
readers, the kernel patterns and the limits of the correctness check.

Each of those is a file of its own, so a later cell, configuration,
mix, metric or kernel pattern is a new file and a new BENCHMARK.json
entry, and no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

__all__ = ["BENCH", "ROOT", "Spec", "load_spec", "load_reader",
           "kernel_patterns"]

BENCH = Path(__file__).resolve().parent.parent          # btbench/
ROOT = BENCH.parent                                      # the checkout


class Spec:
    """One cell as a run sees it."""

    def __init__(self, bench: dict, workload: str, root: Path = ROOT,
                 bench_dir: Path = BENCH):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        cell = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads((root / configs[cell["config"]]["file"])
                                 .read_text())
        self.bench_dir = bench_dir
        self.traffic_path = bench_dir / "traffic" / f"{cell['traffic']}.json"
        self.chips = int(cell["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]
        self.limits = json.loads((bench_dir / "checks" /
                                  f"{workload}.json").read_text())


def load_spec(workload: str, root: Path = ROOT, bench_dir: Path = BENCH):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return Spec(bench, workload, root, bench_dir)


def load_reader(name: str, bench_dir: Path = BENCH):
    """The read(run) function of btbench/metrics/<name>.py."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "btbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_patterns(group: str, bench_dir: Path = BENCH) -> list:
    """The compiled name patterns of btbench/kernels/<group>/*.txt, one
    regular expression per non-empty line that is not a comment."""
    pats = []
    for f in sorted((bench_dir / "kernels" / group).glob("*.txt")):
        for line in f.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                pats.append(re.compile(line))
    return pats
