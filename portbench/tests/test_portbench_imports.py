"""Nothing the harness runs imports jax, jaxlib, flax or the JAX package
gaussiansplat_tpu (top-level names compared whole, so that
gaussiansplat_tpu_torch does not match), and nothing in
portbench/reference/ imports gaussiansplat_tpu_torch or the harness."""

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PB = REPO / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "gaussiansplat_tpu"}


def _imports(path: Path):
    """Top-level module names a file imports (relative imports as
    'portbench')."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("portbench" if node.level else node.module.split(".")[0])
    return names


def test_the_harness_imports_no_jax():
    files = [p for p in PB.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        assert not _imports(p) & FORBIDDEN, p


def test_the_reference_imports_nothing_of_the_program():
    for p in (PB / "reference").rglob("*.py"):
        names = _imports(p)
        assert "gaussiansplat_tpu_torch" not in names, p
        assert not names & FORBIDDEN, p
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                # only siblings inside reference/
                assert node.level == 1, p


def test_a_run_leaves_no_jax_in_sys_modules(tmp_path):
    script = f"""
import io, sys
from contextlib import redirect_stdout
sys.path[:0] = [{str(REPO)!r}, {str(PB / 'tests')!r}]
from pathlib import Path
from tiny import make_root
from portbench import run, harness
root = make_root(Path({str(tmp_path)!r}))
with redirect_stdout(io.StringIO()):
    rc = run.main(["--workload", "tiny_serve", "--seed", "3", "--seconds",
                   "0.2", "--trace", "0"], root=root, device="cpu")
print(rc, sorted(m for m in sys.modules if m.split(".")[0] in {sorted(FORBIDDEN)!r}))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "0 []"


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path):
    """The check comes after the per-layer readers, which run in the
    process that prints the result."""
    script = f"""
import json, sys
sys.path[:0] = [{str(REPO)!r}, {str(PB / 'tests')!r}]
from pathlib import Path
from tiny import make_root
from portbench import run
root = make_root(Path({str(tmp_path)!r}))
(root / "portbench" / "metrics" / "loads_flax.serve.py").write_text(
    "import sys, types\\n"
    "def read(run):\\n"
    "    sys.modules['flax'] = types.ModuleType('flax')\\n"
    "    return 1.0\\n")
spec = json.loads((root / "BENCHMARK.json").read_text())
spec["per_layer"].append(dict(name="loads_flax.serve", unit="%",
                              better="higher", source="program_counter",
                              layer="binning", moves="frames_per_s",
                              workloads=["tiny_serve"]))
(root / "BENCHMARK.json").write_text(json.dumps(spec))
sys.exit(run.main(["--workload", "tiny_serve", "--seed", "3", "--seconds",
                   "0.2", "--trace", "1"], root=root, device="cpu"))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert out.stderr.strip().splitlines()[-1] == (
        "portbench: the run loaded flax")
