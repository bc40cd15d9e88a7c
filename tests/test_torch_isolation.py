"""The port stands alone: importing every module of dryad_tpu_torch pulls
in neither jax nor dryad_tpu (checked in a fresh interpreter and by an
import scan of the source), and its entry points default to the CUDA
card — refusing, not falling back to the CPU, where there is none."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import dryad_tpu_torch
from dryad_tpu_torch.parallel.mesh import resolve_device
from tests.torch_threads import one_torch_thread  # noqa: F401

PKG = pathlib.Path(dryad_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "dryad_tpu" or name.startswith("dryad_tpu."))


def test_import_leaves_jax_and_dryad_tpu_out():
    mods = _modules()
    assert "dryad_tpu_torch.ops.hopper_kernels" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'dryad_tpu' or "
            "m.startswith('dryad_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_dryad_tpu(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert not _forbidden(name), f"{path}: imports {name}"


def test_context_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryad_tpu_torch.Context()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert dryad_tpu_torch.Context(device="cpu").device.type == "cpu"


def test_store_and_text_never_load_the_jax_native_library(tmp_path):
    """A store round trip and read_text in a fresh interpreter map the
    port's own checksum library, never the JAX package's
    native/libdryad_io.so."""
    code = (
        "import numpy as np\n"
        "from dryad_tpu_torch import Context\n"
        "ctx = Context(device='cpu', nparts=4)\n"
        f"p = {str(tmp_path)!r}\n"
        "ctx.from_columns({'k': np.arange(50, dtype=np.int32), "
        "'s': ['x%d' % i for i in range(50)]}).to_store(p + '/st')\n"
        "assert len(ctx.from_store(p + '/st').collect()['k']) == 50\n"
        "open(p + '/t.txt', 'w').write('a\\nb\\n')\n"
        "assert ctx.read_text(p + '/t.txt').collect()['line'] == "
        "[b'a', b'b']\n"
        "maps = open('/proc/self/maps').read()\n"
        "print('libdryad_io' in maps, 'libhost_fnv' in maps)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "True"]


NEW_MODULES = ("dryad_tpu_torch.oracle", "dryad_tpu_torch.adapt",
               "dryad_tpu_torch.adapt.thresholds",
               "dryad_tpu_torch.adapt.stats", "dryad_tpu_torch.adapt.rewrite",
               "dryad_tpu_torch.adapt.rules", "dryad_tpu_torch.adapt.manager",
               "dryad_tpu_torch.analysis",
               "dryad_tpu_torch.analysis.diagnostics",
               "dryad_tpu_torch.analysis.domain",
               "dryad_tpu_torch.analysis.cost", "dryad_tpu_torch.obs",
               "dryad_tpu_torch.obs.metrics")


def test_oracle_adapt_cost_modules_are_checked():
    """The oracle, adaptive-execution, cost-model and metrics modules are
    among those the two checks above import and scan."""
    assert set(NEW_MODULES) <= set(_modules())


def test_oracle_cost_and_adaptive_runs_load_no_jax():
    """A local_debug collect, a cost report with its cross-checked run
    and an adaptive run, in a fresh interpreter: neither jax nor
    dryad_tpu is loaded."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from dryad_tpu_torch import Context, JobConfig\n"
        "from dryad_tpu_torch.analysis.cost import estimate_graph\n"
        "cols = {'k': np.arange(4000, dtype=np.int32) % 9,\n"
        "        'v': np.arange(4000, dtype=np.int32)}\n"
        "def q(c):\n"
        "    return c.from_columns(cols).group_by(['k'], {'s': ('sum', 'v')})"
        ".hash_partition(['s'])\n"
        "dbg = Context(device='cpu', local_debug=True)\n"
        "assert len(q(dbg).collect()['k']) == 9\n"
        "ctx = Context(device='cpu', config=JobConfig(adaptive='on'))\n"
        "g = q(ctx).plan()\n"
        "ctx.executor.run(g, cost_report=estimate_graph(g, 8))\n"
        "assert ctx.executor._last_run_rewrites == 1\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'dryad_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


STREAM_MODULES = ("dryad_tpu_torch.exec.ooc",
                  "dryad_tpu_torch.exec.stream_exec",
                  "dryad_tpu_torch.exec.autotune")


def test_streaming_modules_are_checked():
    """The out-of-core modules are among those the checks above import
    and scan."""
    assert set(STREAM_MODULES) <= set(_modules())


def test_streamed_runs_load_no_jax(tmp_path):
    """A streamed sort, group-by and cache() over a store, and the
    out-of-core TeraSort app, in a fresh interpreter: neither jax nor
    dryad_tpu is loaded."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from dryad_tpu_torch import Context, JobConfig\n"
        "from dryad_tpu_torch.apps.terasort import terasort_ooc\n"
        f"d = {str(tmp_path)!r}\n"
        "Context(device='cpu', nparts=2).from_columns(\n"
        "    {'k': np.arange(5000, dtype=np.int32) % 7}).to_store(d + '/s')\n"
        "ctx = Context(device='cpu', config=JobConfig(ooc_cache_dir=d + '/c'))\n"
        "ds = ctx.read_store_stream(d + '/s', chunk_rows=512).cache()\n"
        "assert ds.order_by([('k', True)]).count() == 5000\n"
        "assert len(ds.group_by(['k'], {'n': ('count', None)})"
        ".collect()['k']) == 7\n"
        "m = terasort_ooc(3000, 700, out_store=d + '/t', device='cpu')\n"
        "assert sum(m['counts']) == 3000\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'dryad_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
