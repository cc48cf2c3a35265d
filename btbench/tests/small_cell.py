"""A checkout of the benchmark at a size the CPU runs in seconds: a copy
of btbench/ and BENCHMARK.json in a temporary directory, with the
narrow-band configuration cut to 64-slot blocks."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from btbench.harness import spec as specs

ROOT = specs.ROOT


def small_copy(tmp: Path, block_slots: int = 64) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(specs.BENCH, root / "btbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    cfg_path = root / "btbench" / "configs" / "band8_8msps.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["block_slots"] = block_slots
    cfg_path.write_text(json.dumps(cfg))
    return root


def spec(root: Path, workload: str):
    return specs.load_spec(workload, root=root, bench_dir=root / "btbench")


def add_live_cell(root: Path, name: str = "band8.live"):
    """The narrow-band configuration under the live mix, as a new cell:
    a BENCHMARK.json entry and a limits file."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name=name, config="band8_8msps",
                                   traffic="live", chips=1, why="test"))
    for m in bench["end_to_end"]:
        if m["name"] == "result_latency_p95_ms":
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(root / "btbench" / "checks" / "band8.maxrate.json",
                root / "btbench" / "checks" / f"{name}.json")


def add_survey_cell(root: Path, name: str = "band8.survey_4card"):
    """The narrow-band configuration under the survey mix on four time
    shards, as a new cell (the shards are CPU devices here)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name=name, config="band8_8msps",
                                   traffic="survey", chips=4, why="test"))
    for m in bench["end_to_end"]:
        if m["name"] == "samples_per_s":
            m["workloads"].append(name)
    bench["per_layer"].append(dict(
        name="sharded.ms_per_superblock", unit="ms", better="lower",
        source="host_clock", layer="sharded front end",
        moves="samples_per_s", workloads=[name]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(root / "btbench" / "checks" / "band8.maxrate.json",
                root / "btbench" / "checks" / f"{name}.json")
