"""Import guard: nothing the benchmark runs loads JAX or the JAX package;
the plain reference loads nothing of the program either; nothing reads the
old benchmark folder or its result files."""

import ast
import json
import subprocess
import sys

import pytest

from slam_bench.harness import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "lego_loam_tpu"}
PKG = REPO / "slam_bench"
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def _loaded_after(code):
    """Top-level names in ``sys.modules`` after running ``code`` in a fresh
    interpreter at the repository root."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=240,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_sources_import_no_jax():
    assert SOURCES
    for path in SOURCES:
        # whole top-level names: lego_loam_tpu_torch is the program
        assert not (_top_level_imports(path) & FORBIDDEN), path


def test_everything_the_benchmark_runs_loads_no_jax():
    metric_files = sorted((PKG / "metrics").glob("*.py"))
    code = "\n".join([
        "import slam_bench.run, slam_bench.control, slam_bench.harness",
        "import slam_bench.trace, slam_bench.gen.scans, slam_bench.reference.truth",
        "from slam_bench.harness import Bench, build_config",
        "b = Bench()",
        *[f"b.reader({p.stem!r})" for p in metric_files
          if not p.stem.startswith("_")],
        "import slam_bench.metrics._arith",
        "for w in b.spec['workloads']:",
        "    build_config(b.config(w['config']))",
        "import lego_loam_tpu_torch.pipeline.slam, lego_loam_tpu_torch.io.native_feeder",
        "import torch.profiler",
    ])
    loaded = _loaded_after(code)
    assert "lego_loam_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    for path in sorted((PKG / "reference").glob("*.py")):
        assert _top_level_imports(path) <= {"__future__", "typing", "numpy",
                                            "math", "torch"}, path
    loaded = _loaded_after("import slam_bench.reference.truth, "
                           "slam_bench.reference.stages")
    assert not loaded & (FORBIDDEN | {"lego_loam_tpu_torch"})


@pytest.mark.parametrize("needle", ["benchmarks/", "benchmarks\\", "BENCH_",
                                    "bench.py", "_r0"])
def test_nothing_reads_the_old_benchmark_files(needle):
    for path in SOURCES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert needle not in node.value, (path, node.value[:80])
