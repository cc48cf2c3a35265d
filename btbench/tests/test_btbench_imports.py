"""Nothing the benchmark runs imports JAX or the JAX package, compared
by whole top-level names, and the yardstick imports nothing of the
port."""
import ast
import subprocess
import sys
from pathlib import Path

from btbench.harness.main import forbidden_modules
from small_cell import ROOT

BENCH = ROOT / "btbench"


def test_names_compare_whole():
    mods = {"gr_bluetooth_tpu_torch": 1, "gr_bluetooth_tpu_torch.ops": 1,
            "jaxtyping": 1, "numpy": 1}
    assert forbidden_modules(mods) == []
    for bad in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                "gr_bluetooth_tpu", "gr_bluetooth_tpu.ops.pfb"):
        assert forbidden_modules({**mods, bad: 1}) == \
            [bad.split(".")[0]]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_neither_jax_nor_the_jax_package():
    for f in BENCH.rglob("*.py"):
        tops = set(_imports(f))
        assert not tops & {"jax", "jaxlib", "flax", "gr_bluetooth_tpu"}, f
        if f.parent.name != "tests" and \
                {"reference", "traffic"} & set(f.relative_to(BENCH).parts):
            assert "gr_bluetooth_tpu_torch" not in tops, f


def test_a_run_holds_no_forbidden_module(tmp_path):
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(BENCH / 'tests')!r}]
from pathlib import Path
from small_cell import small_copy, spec
from btbench.harness.main import run_cell, forbidden_modules
root = small_copy(Path({str(tmp_path)!r}))
out, _ = run_cell(spec(root, "band8.maxrate"), 5, 0.3, False, device="cpu")
print(out["correct"], forbidden_modules())
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "True []"
