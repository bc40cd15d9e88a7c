"""Nothing the harness runs imports JAX or the JAX package, and the plain
references import nothing of the port.  Each check runs in a fresh
interpreter, so nothing else of the test session is in ``sys.modules``;
top-level names are compared whole (``dryad_tpu_torch`` is not
``dryad_tpu``)."""

import ast
import glob
import json
import os
import subprocess
import sys

from conftest import ROOT

from portbench import bench

PB = os.path.join(ROOT, "portbench")


def modules_after(code: str) -> set:
    """Top-level names in ``sys.modules`` after running ``code``."""
    p = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_traffic_and_references_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import glob, os\n"
        "from portbench import bench, control, devtrace, roofline\n"
        "import dryad_tpu_torch\n"
        "for w in ('tpch.q3', 'terasort.100b'):\n"
        "    bench.Cell(w)\n"
        "for f in sorted(glob.glob('portbench/metrics/*.py')):\n"
        "    bench.reader(os.path.basename(f)[:-3])\n")
    names = modules_after(code)
    assert "dryad_tpu_torch" in names
    assert not names & set(bench.FORBIDDEN), names & set(bench.FORBIDDEN)


def test_references_import_nothing_of_the_port():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench import bench\n"
        "import glob, os\n"
        "for f in sorted(glob.glob('portbench/reference/*.py')):\n"
        "    bench.load_file(f, 'ref_' + os.path.basename(f)[:-3])\n")
    names = modules_after(code)
    assert not names & ({"dryad_tpu_torch"} | set(bench.FORBIDDEN))


def test_reference_sources_name_no_port_module():
    for f in glob.glob(os.path.join(PB, "reference", "*.py")):
        tree = ast.parse(open(f).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in (
                    "dryad_tpu_torch", "dryad_tpu", "jax", "jaxlib",
                    "flax"), (f, n)


def test_forbidden_names_compared_whole():
    assert bench.forbidden_modules(["dryad_tpu_torch", "dryad_tpu_torch.api",
                                    "jaxtyping", "numpy"]) == []
    assert bench.forbidden_modules(["dryad_tpu.api", "jax.numpy",
                                    "jaxlib", "flax.linen"]) == [
        "dryad_tpu", "flax", "jax", "jaxlib"]


def test_harness_reads_no_old_benchmark():
    for f in glob.glob(os.path.join(PB, "**", "*.py"), recursive=True):
        if f.endswith(os.path.join("tests", "test_portbench_isolation.py")):
            continue
        src = open(f).read()
        for old in ("bench.py", "benchmarks/", "BENCH_", "MULTICHIP_",
                    "BASELINE.json", "chip_smoke"):
            assert old not in src, (f, old)
