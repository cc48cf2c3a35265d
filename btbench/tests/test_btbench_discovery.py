"""The harness finds cells, configurations, traffic mixes, metric
readers and kernel patterns by name, and a new one of each needs only
new files and new BENCHMARK.json entries."""
import json
import re

from btbench.harness import spec as specs
from btbench.harness.main import run_cell
from small_cell import ROOT, small_copy, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_follows_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["btbench"] and b["command"][1] == "btbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", [w])
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_name_resolves_to_its_files():
    b = _bench()
    for w in b["workloads"]:
        sp = specs.load_spec(w["name"])
        assert sp.config["name"] == w["config"]
        assert sp.traffic_path.exists()
        assert set(sp.limits) == {"hit_mismatch", "snr_gap_db",
                                  "mode_mismatch", "unfinished"}
        for m in sp.end_to_end + sp.per_layer:
            assert callable(specs.load_reader(m["name"]))
    pats = specs.kernel_patterns("k1")
    hit = [n for n in ("void pfb_snr_kernel<5>(SnrSrc, pfb::Bank)",
                       "demod_pack_kernel((anonymous namespace)::Args)",
                       "le_detect_kernel(unsigned int const*)",
                       "hit_table_kernel(Tails)")
           if any(p.search(n) for p in pats)]
    assert hit == ["void pfb_snr_kernel<5>(SnrSrc, pfb::Bank)",
                   "demod_pack_kernel((anonymous namespace)::Args)"]


def test_a_new_cell_config_mix_metric_and_pattern_are_new_files(tmp_path):
    root = small_copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "btbench").rglob("*")
              if p.is_file()}
    bb = root / "btbench"
    cfg = json.loads((bb / "configs" / "band8_8msps.json").read_text())
    cfg["name"] = "band6_6msps"
    cfg["sample_rate"] = 6e6
    (bb / "configs" / "band6_6msps.json").write_text(json.dumps(cfg))
    (bb / "traffic" / "short.json").write_text(json.dumps(dict(
        loop="closed", air="max_rate", pass_slots=128, warmup_passes=1)))
    (bb / "metrics" / "blocks_seen.py").write_text(
        "def read(run):\n    return float(len(run.window.done))\n")
    (bb / "kernels" / "k1" / "fused.txt").write_text("pfb_fused\n")
    (bb / "checks" / "band6.short.json").write_text(json.dumps(dict(
        hit_mismatch=0, snr_gap_db=0.0006, mode_mismatch=0,
        unfinished=0)))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append(dict(name="band6_6msps", source="x",
                             file="btbench/configs/band6_6msps.json",
                             reduced=[], why="x"))
    b["workloads"].append(dict(name="band6.short", config="band6_6msps",
                               traffic="short", chips=1, why="x"))
    b["end_to_end"][0]["workloads"].append("band6.short")
    b["per_layer"].append(dict(name="blocks_seen", unit="blocks",
                               better="higher", source="host_clock",
                               layer="load generator",
                               moves="samples_per_s",
                               workloads=["band6.short"]))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    after = {p: p.read_bytes() for p in before}
    assert after == before                       # no file was edited
    assert any(p.search("pfb_fused_kernel")
               for p in specs.kernel_patterns("k1", bb))
    out, _ = run_cell(spec(root, "band6.short"), 11, 0.5, True, device="cpu")
    assert out["correct"], out["check"]
    assert out["metrics"]["blocks_seen"]["value"] >= 1
