"""Nothing the benchmark imports is JAX, a JAX library or the JAX
package, compared by whole top-level names (`rsvldm_tpu_torch` begins
with `rsvldm_tpu`); the reference imports nothing of the program either."""

import ast
import subprocess
import sys
from pathlib import Path

import run

BENCH = Path(run.__file__).resolve().parent
JAXISH = {"jax", "jaxlib", "flax", "optax", "orbax", "rsvldm_tpu"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_modules_whole_names():
    assert run.forbidden_modules(["rsvldm_tpu_torch", "rsvldm_tpu_torch.ops",
                                  "torch", "jaxtyping"]) == []
    assert run.forbidden_modules(["jax.numpy", "rsvldm_tpu.pipeline",
                                  "flax", "torch"]) == ["flax", "jax",
                                                        "rsvldm_tpu"]
    assert run.forbidden_modules(["orbax.checkpoint", "optax",
                                  "jaxlib.xla"]) == ["jaxlib", "optax", "orbax"]


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & JAXISH, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = _imports(path)
        assert "rsvldm_tpu_torch" not in names and not names & JAXISH, path


def test_loaded_modules_hold_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import run; "
            "import harness.cell, harness.check, harness.counting, "
            "harness.trace, harness.weights, reference.pipeline, "
            "rsvldm_tpu_torch.pipeline, rsvldm_tpu_torch.models.vlm.captioner; "
            "from harness import manifest; "
            "[manifest.driver(p.stem) for p in manifest.BENCH_DIR.glob('drivers/*.py')]; "
            "[manifest.builder(p.stem) for p in manifest.BENCH_DIR.glob('builders/*.py')]; "
            "print(run.forbidden_modules())") % (str(BENCH.parent), str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=run.os.environ | run.cache_env())
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
