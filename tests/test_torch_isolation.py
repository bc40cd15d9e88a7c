"""The port stands alone: importing every module of dryad_tpu_torch pulls
in neither jax nor dryad_tpu (checked in a fresh interpreter and by an
import scan of the source), and its entry points default to the CUDA
card — refusing, not falling back to the CPU, where there is none."""

import ast
import os
import pathlib
import subprocess
import sys
import time

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


SQL_MODULES = ("dryad_tpu_torch.sql", "dryad_tpu_torch.sql.__main__",
               "dryad_tpu_torch.sql.binder", "dryad_tpu_torch.sql.catalog",
               "dryad_tpu_torch.sql.errors", "dryad_tpu_torch.sql.lexer",
               "dryad_tpu_torch.sql.lower", "dryad_tpu_torch.sql.nodes",
               "dryad_tpu_torch.sql.parser", "dryad_tpu_torch.sql.rowexpr",
               "dryad_tpu_torch.plan.serialize",
               "dryad_tpu_torch.analysis.__main__",
               "dryad_tpu_torch.analysis.plan_rules",
               "dryad_tpu_torch.analysis.udf_lint")


def test_sql_and_analysis_modules_are_checked():
    """The SQL front end, the JSON plan and the static checker are among
    the modules the two checks above import and scan."""
    assert set(SQL_MODULES) <= set(_modules())


def test_sql_cli_and_checker_load_no_jax(tmp_path):
    """``python -m dryad_tpu_torch.sql`` (an offline EXPLAIN and a SELECT
    on the CPU), a lint-gated query with its plan event, ``check()`` and
    ``python -m dryad_tpu_torch.analysis`` in a fresh interpreter: neither
    jax nor dryad_tpu is loaded."""
    cat = str(tmp_path / "cat.json")
    plan = str(tmp_path / "plan.json")
    code = (
        "import runpy, sys\n"
        "import numpy as np\n"
        "from dryad_tpu_torch import Context, JobConfig, sql\n"
        "from dryad_tpu_torch.utils.events import EventLog\n"
        "c = sql.Catalog().register_columns('t', {\n"
        "    'k': np.arange(300, dtype=np.int32) % 7,\n"
        "    's': [b'a' if i % 2 else b'b' for i in range(300)]})\n"
        f"c.save({cat!r})\n"
        "def cli(mod, *args):\n"
        "    sys.argv = [mod, *args]\n"
        "    try:\n"
        "        runpy.run_module(mod, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert not e.code, e.code\n"
        f"cli('dryad_tpu_torch.sql', '--catalog', {cat!r}, '-e',\n"
        "    'EXPLAIN SELECT k, COUNT(*) AS n FROM t GROUP BY k')\n"
        f"cli('dryad_tpu_torch.sql', '--catalog', {cat!r}, '--device',\n"
        "    'cpu', '-e', \"SELECT k FROM t WHERE s = 'a' ORDER BY k "
        "LIMIT 2\")\n"
        "log = EventLog()\n"
        "ctx = Context(device='cpu', event_log=log,\n"
        "              config=JobConfig(lint='warn'))\n"
        "q = sql.query(ctx, c, 'SELECT k, COUNT(*) AS n FROM t GROUP BY k')\n"
        "assert len(q.collect()['k']) == 7 and q.check().clean\n"
        "p = log.of_type('plan')[0]['plan']\n"
        f"open({plan!r}, 'w').write(p)\n"
        f"cli('dryad_tpu_torch.analysis', {plan!r}, '--cost')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'dryad_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert "k | n" not in out.stdout and "output: stage" in out.stdout


INC_REMOTE_MODULES = ("dryad_tpu_torch.inc", "dryad_tpu_torch.inc.state",
                      "dryad_tpu_torch.inc.delta_plan",
                      "dryad_tpu_torch.inc.refresh",
                      "dryad_tpu_torch.io.providers",
                      "dryad_tpu_torch.io.http_provider",
                      "dryad_tpu_torch.io.s3", "dryad_tpu_torch.io.s3_store",
                      "dryad_tpu_torch.io.webhdfs")


def test_inc_and_remote_modules_are_checked():
    """The incremental layer and the network stores are among the modules
    the two checks above import and scan."""
    assert set(INC_REMOTE_MODULES) <= set(_modules())


@pytest.mark.parametrize("name", ["tests/torch_fakes.py",
                                  "tests/webhdfs_fake.py",
                                  "tests/torch_cluster_fns.py",
                                  "chip_smoke.py"])
def test_chip_smoke_and_its_fakes_import_no_jax(name):
    """chip_smoke.py, the loopback fakes it starts and the UDFs its
    workers import import neither jax nor dryad_tpu."""
    tree = ast.parse((ROOT / name).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (name, names)


def test_refresh_and_remote_stores_load_no_jax(tmp_path):
    """A refresh over an appended store, an s3:// and an hdfs:// store
    round trip on the loopback fakes, in a fresh interpreter: neither jax
    nor dryad_tpu is loaded."""
    code = (
        "import os, sys\n"
        "import numpy as np\n"
        "from dryad_tpu_torch import Context, sql\n"
        "from dryad_tpu_torch.inc import run_refresh\n"
        "from dryad_tpu_torch.io.store import append_store\n"
        "from tests.torch_fakes import FakeS3\n"
        "sys.path.insert(0, 'tests')\n"
        "from webhdfs_fake import FakeWebHdfs\n"
        f"d = {str(tmp_path)!r}\n"
        "ctx = Context(device='cpu', nparts=2)\n"
        "cols = {'k': np.arange(50, dtype=np.int32) % 3}\n"
        "ctx.from_columns(cols).to_store(d + '/s')\n"
        "cat = sql.Catalog().register_store('t', d + '/s')\n"
        "q = 'SELECT k, COUNT(*) AS n FROM t GROUP BY k EMIT EVERY 1'\n"
        "b = sql.compile_query(cat, q)[1]\n"
        "run_refresh(ctx, cat, b, q, d + '/st')\n"
        "append_store(d + '/s', ctx.from_columns(cols).node.data)\n"
        "r = run_refresh(ctx, cat, b, q, d + '/st')\n"
        "assert r.mode == 'incremental' and sum(r.table['n']) == 100\n"
        "with FakeS3() as f:\n"
        "    os.environ.update(f.environ())\n"
        "    ctx.from_columns(cols).to_store('s3://b/s')\n"
        "    assert ctx.from_store('s3://b/s').count() == 50\n"
        "h = FakeWebHdfs()\n"
        "ctx.from_columns(cols).to_store(h.url + '/s')\n"
        "assert ctx.from_store(h.url + '/s').count() == 50\n"
        "h.close()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'dryad_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


SERVICE_MODULES = ("dryad_tpu_torch.service", "dryad_tpu_torch.service.daemon",
                   "dryad_tpu_torch.service.http",
                   "dryad_tpu_torch.service.__main__",
                   "dryad_tpu_torch.service.durable",
                   "dryad_tpu_torch.service.durable.journal",
                   "dryad_tpu_torch.service.durable.recover",
                   "dryad_tpu_torch.inc.standing", "dryad_tpu_torch.obs.slo",
                   "dryad_tpu_torch.utils.compile_cache",
                   "dryad_tpu_torch.runtime.shiplan")


def test_service_modules_are_checked():
    """The job service, its durable journal, the standing queries, the SLO
    tracker, the FileCache and the shipping helpers are among the modules
    the two checks above import and scan."""
    assert set(SERVICE_MODULES) <= set(_modules())


def test_service_cli_help_and_a_cpu_daemon_load_no_jax(tmp_path):
    """``python -m dryad_tpu_torch.service --help`` in a fresh interpreter,
    then a CPU daemon running one wordcount job and one SQL job: neither
    jax nor dryad_tpu is loaded."""
    help_out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "dryad_tpu_torch.service",
         "--help"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert help_out.returncode == 0, help_out.stderr
    assert "serve" in help_out.stdout
    loaded = [line.rsplit("|", 1)[-1].strip()
              for line in help_out.stderr.splitlines()
              if line.startswith("import time:")]
    assert "dryad_tpu_torch.service" in loaded
    assert not [m for m in loaded if _forbidden(m)]
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from dryad_tpu_torch import sql\n"
        "from dryad_tpu_torch.service import JobService, ServiceConfig\n"
        "cat = sql.Catalog().register_columns(\n"
        "    't', {'k': np.arange(40, dtype=np.int32) % 3})\n"
        f"svc = JobService(ServiceConfig({str(tmp_path)!r}), device='cpu',\n"
        "                 catalog=cat)\n"
        "a = svc.submit('wordcount', {'n_lines': 16})\n"
        "b = svc.submit_sql('SELECT k, COUNT(*) AS n FROM t GROUP BY k')\n"
        "assert svc.wait(a, 120)['state'] == 'done'\n"
        "assert svc.wait(b, 120)['result']['rows'] == 3\n"
        "svc.close()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'dryad_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


CLUSTER_MODULES = ("dryad_tpu_torch.runtime",
                   "dryad_tpu_torch.runtime.protocol",
                   "dryad_tpu_torch.runtime.interfaces",
                   "dryad_tpu_torch.runtime.sources",
                   "dryad_tpu_torch.runtime.shiplan",
                   "dryad_tpu_torch.runtime.worker",
                   "dryad_tpu_torch.runtime.cluster",
                   "dryad_tpu_torch.runtime.farm",
                   "dryad_tpu_torch.obs.flight", "dryad_tpu_torch.chaos",
                   "dryad_tpu_torch.chaos.plan",
                   "dryad_tpu_torch.chaos.faults",
                   "dryad_tpu_torch.chaos.invariants",
                   "dryad_tpu_torch.chaos._victim",
                   "dryad_tpu_torch.chaos.harness",
                   "dryad_tpu_torch.chaos.__main__")


def test_cluster_and_chaos_modules_are_checked():
    """The worker processes' runtime, the task farm, the forensics
    bundles and the chaos harness are among the modules the two checks
    above import and scan."""
    assert set(CLUSTER_MODULES) <= set(_modules())


def test_workers_farm_and_victim_load_no_jax(tmp_path):
    """In a fresh interpreter, started in a directory that holds a decoy
    ``dryad_tpu_torch`` (one that raises on import): a CPU
    ``LocalCluster`` whose workers run as ``python -m
    dryad_tpu_torch.runtime.worker`` (from that directory: they import the
    driver's package, not the decoy) farms a task whose UDF raises if its
    worker loaded jax or dryad_tpu, and the driver loads neither;
    ``python -m dryad_tpu_torch.chaos._victim`` runs until its manifest
    is written, with neither among its imports; ``python -m
    dryad_tpu_torch.chaos --help`` exits 0."""
    tests = str(ROOT / "tests")
    decoy = tmp_path / "decoy"
    (decoy / "dryad_tpu_torch").mkdir(parents=True)
    (decoy / "dryad_tpu_torch" / "__init__.py").write_text(
        "raise ImportError('the decoy package was imported')\n")
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import numpy as np\n"
        "import torch_cluster_fns as F\n"
        "from dryad_tpu_torch import Context\n"
        "from dryad_tpu_torch.plan.planner import plan_query\n"
        "from dryad_tpu_torch.runtime import LocalCluster\n"
        "from dryad_tpu_torch.runtime.farm import TaskFarm\n"
        "from dryad_tpu_torch.runtime.shiplan import serialize_for_cluster\n"
        "from dryad_tpu_torch.runtime.sources import columns_spec\n"
        "cl = LocalCluster(n_processes=1, devices_per_process=2,\n"
        "                  fn_modules=('torch_cluster_fns',), device='cpu')\n"
        "try:\n"
        "    ds = Context(cluster=cl).from_columns(\n"
        "        {'v': np.arange(4, dtype=np.int32)}).select(F.no_jax_loaded)\n"
        "    plan, specs = serialize_for_cluster(plan_query(ds.node, 2))\n"
        "    (k,) = specs\n"
        "    out = TaskFarm(cl).run(plan, [{k: columns_spec(\n"
        "        {'v': np.arange(9, dtype=np.int32)}, 2)}])\n"
        "    assert sorted(out[0]['v'].tolist()) == list(range(9))\n"
        "finally:\n"
        "    cl.shutdown()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'dryad_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=tests + os.pathsep + str(ROOT),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=decoy, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    d = tmp_path / "victim"
    d.mkdir()
    with open(tmp_path / "victim.err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m",
             "dryad_tpu_torch.chaos._victim", "--dir", str(d), "--seed",
             "3", "--device", "cpu"], cwd=ROOT, env=env,
            stdout=subprocess.DEVNULL, stderr=err)
        try:
            deadline = time.time() + 240
            while not (d / "manifest.json").exists():
                assert proc.poll() is None and time.time() < deadline
                time.sleep(0.1)
        finally:
            proc.kill()
            proc.wait()
    loaded = [line.rsplit("|", 1)[-1].strip()
              for line in (tmp_path / "victim.err").read_text().splitlines()
              if line.startswith("import time:")]
    assert "dryad_tpu_torch.chaos.plan" in loaded
    assert "dryad_tpu_torch.service.daemon" in loaded
    assert not [m for m in loaded if _forbidden(m)]
    help_out = subprocess.run(
        [sys.executable, "-m", "dryad_tpu_torch.chaos", "--help"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert help_out.returncode == 0 and "--device" in help_out.stdout


GANG_MODULES = ("dryad_tpu_torch.runtime.exec_common",
                "dryad_tpu_torch.runtime.stream_cluster",
                "dryad_tpu_torch.parallel.mesh")


def test_gang_modules_are_checked():
    """The gang's job body, its parallel collect and store output, and the
    mesh's collectives are among the modules the two checks above import
    and scan."""
    assert set(GANG_MODULES) <= set(_modules())


def test_gang_jobs_load_no_jax():
    """In a fresh interpreter: a gang of two CPU workers (gloo) runs a
    query with an exchange, a resident cache() and a do_while whose UDF
    raises if its worker loaded jax or dryad_tpu; the driver loads
    neither."""
    tests = str(ROOT / "tests")
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch_cluster_fns as F\n"
        "from dryad_tpu_torch import Context\n"
        "from dryad_tpu_torch.runtime import LocalCluster\n"
        "cl = LocalCluster(n_processes=2, devices_per_process=2,\n"
        "                  fn_modules=('torch_cluster_fns',), device='cpu')\n"
        "try:\n"
        "    ctx = Context(cluster=cl)\n"
        "    ds = ctx.from_columns({'v': np.arange(40, dtype=np.int32) % 7})"
        ".select(F.no_jax_loaded).cache()\n"
        "    g = ds.group_by(['v'], {'n': ('count', None)}).collect()\n"
        "    assert sorted(g['v'].tolist()) == list(range(7))\n"
        "    out = ctx.do_while(ds, lambda d: d.select(F.no_jax_loaded)"
        ".select(F.inc_v), n_iters=2).collect()\n"
        "    assert sorted(out['v'].tolist()) == sorted("
        "(np.arange(40) % 7 + 2).tolist())\n"
        "finally:\n"
        "    cl.shutdown()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'dryad_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=tests + os.pathsep + str(ROOT),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


STREAM_GANG_MODULES = ("dryad_tpu_torch.runtime.stream_plan",
                       "dryad_tpu_torch.runtime.ssh_cluster")


def test_stream_gang_and_ssh_modules_are_checked():
    """The streamed gang's runner and the SSH backend are among the
    modules the two checks above import and scan."""
    assert set(STREAM_GANG_MODULES) <= set(_modules())


def test_streamed_gang_and_ssh_jobs_load_no_jax(tmp_path):
    """In a fresh interpreter: a gang of two CPU workers streams a store
    through a hash exchange in waves, and an ``SshCluster`` over ``bash
    -c`` runs a job on its staged copy, both with a UDF that raises if
    its worker loaded jax or dryad_tpu; the driver loads neither."""
    tests = str(ROOT / "tests")
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch_cluster_fns as F\n"
        "from dryad_tpu_torch import Context\n"
        "from dryad_tpu_torch.runtime import LocalCluster, SshCluster\n"
        f"src = {str(tmp_path / 'src')!r}\n"
        "Context(device='cpu', nparts=4).from_columns(\n"
        "    {'v': np.arange(400, dtype=np.int32) % 7}).to_store(src)\n"
        "cl = LocalCluster(n_processes=2, devices_per_process=2,\n"
        "                  fn_modules=('torch_cluster_fns',), device='cpu')\n"
        "try:\n"
        "    g = Context(cluster=cl).read_store_stream(src, chunk_rows=32)"
        ".select(F.no_jax_loaded).group_by(['v'], {'n': ('count', None)})"
        ".collect()\n"
        "    assert sorted(g['v'].tolist()) == list(range(7))\n"
        "finally:\n"
        "    cl.shutdown()\n"
        "ssh = SshCluster(hosts=['a', 'b'], devices_per_process=1,\n"
        "                 driver_host='127.0.0.1',\n"
        "                 coordinator_host='127.0.0.1',\n"
        f"                 python=sys.executable, device='cpu',\n"
        f"                 remote_root={str(tmp_path / 'stage')!r},\n"
        f"                 remote_pythonpath=[{tests!r}],\n"
        "                 fn_modules=('torch_cluster_fns',),\n"
        "                 rsh=lambda host, cmd: ['bash', '-c', cmd])\n"
        "try:\n"
        "    n = Context(cluster=ssh).from_columns(\n"
        "        {'v': np.arange(40, dtype=np.int32)})"
        ".select(F.no_jax_loaded).count()\n"
        "    assert n == 40\n"
        "finally:\n"
        "    ssh.shutdown()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'dryad_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=tests + os.pathsep + str(ROOT),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


MESH_MODULES = ("dryad_tpu_torch._lazy", "dryad_tpu_torch.parallel.mesh",
                "dryad_tpu_torch.parallel.shuffle",
                "dryad_tpu_torch.plan.planner",
                "dryad_tpu_torch.adapt.manager",
                "dryad_tpu_torch.data.columnar",
                "dryad_tpu_torch.analysis.cost") + tuple(
    f"dryad_tpu_torch.{s}" for s in ("api", "data", "exec", "io", "ops",
                                     "parallel", "plan", "utils"))


def test_mesh_and_export_modules_are_checked():
    """The multi-axis mesh, the axis exchange, the levelled planner, the
    mesh's levels and the subpackages' lazy exports are among the
    modules the two checks above import and scan."""
    assert set(MESH_MODULES) <= set(_modules())


def test_mesh_query_and_levelled_gang_job_load_no_jax():
    """In a fresh interpreter: a group-by on a (dcn, dp) mesh of eight
    CPU partitions and an ``adaptive="on"`` levelled job on a gang of two
    CPU workers (whose UDF raises if its worker loaded jax or
    dryad_tpu); the driver loads neither."""
    tests = str(ROOT / "tests")
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch_cluster_fns as F\n"
        "from dryad_tpu_torch import Context, JobConfig, make_mesh\n"
        "from dryad_tpu_torch.runtime import LocalCluster\n"
        "v = np.arange(400, dtype=np.int32) % 7\n"
        "ctx = Context(mesh=make_mesh('cpu', 8, hosts=2))\n"
        "d = ctx.from_columns({'v': v}).group_by(['v'], {'n': ('count', None)})\n"
        "assert 'groupby-dcn' in d.explain()\n"
        "assert sorted(d.collect()['v'].tolist()) == list(range(7))\n"
        "cl = LocalCluster(n_processes=2, devices_per_process=2,\n"
        "                  fn_modules=('torch_cluster_fns',), device='cpu')\n"
        "try:\n"
        "    g = Context(cluster=cl, config=JobConfig(adaptive='on'))\n"
        "    out = g.from_columns({'v': v}).select(F.no_jax_loaded)"
        ".group_by(['v'], {'n': ('count', None)}).collect()\n"
        "    assert sorted(out['v'].tolist()) == list(range(7))\n"
        "finally:\n"
        "    cl.shutdown()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'dryad_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=tests + os.pathsep + str(ROOT),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_subpackage_imports_load_nothing_past_the_package():
    """In fresh interpreters: importing a subpackage (its lazy exports)
    loads no module that ``import dryad_tpu_torch`` alone does not, but
    the subpackage and the lazy-export helper: torch is loaded where it
    was before the exports came (by the package itself), never
    earlier."""
    def loaded(stmt):
        out = subprocess.run(
            [sys.executable, "-c",
             f"import sys\n{stmt}\nprint(sorted(sys.modules))"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        return set(eval(out.stdout.strip().splitlines()[-1]))
    base = loaded("import dryad_tpu_torch")
    assert "torch" in base
    for sub in ("api", "data", "exec", "io", "ops", "parallel", "plan",
                "utils"):
        extra = loaded(f"import dryad_tpu_torch.{sub}") - base
        assert extra <= {f"dryad_tpu_torch.{sub}", "dryad_tpu_torch._lazy"}, \
            (sub, sorted(extra))
