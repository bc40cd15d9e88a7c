"""The static cost model on a cluster Context's deferred sources
(``analysis/cost._source_state``): each spec kind seeds the same
abstract state as the JAX package's, and ``Dataset.cost()`` of a query
on a gang Context predicts the same per-stage rows as the same query on
an in-process Context at the same P."""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from dryad_tpu.analysis import cost as jcost  # noqa: E402
from dryad_tpu.runtime.sources import DeferredSource as JDeferred  # noqa: E402
from dryad_tpu.utils.config import JobConfig as JJobConfig  # noqa: E402
from dryad_tpu_torch import Context, make_mesh  # noqa: E402
from dryad_tpu_torch.analysis import cost as tcost  # noqa: E402
from dryad_tpu_torch.runtime import LocalCluster  # noqa: E402
from dryad_tpu_torch.runtime.sources import DeferredSource  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401

P = 8


def _state(s):
    """An AbsState as plain values (the two packages' ColSpecs are
    different classes with the same fields)."""
    schema = (None if s.schema is None else
              {k: (c.kind, c.dtype, tuple(c.shape), c.max_len, c.repeat)
               for k, c in s.schema.items()})
    return (s.rows.lo, s.rows.hi, s.capacity, schema, s.approx,
            list(s.notes))


STORE_SCHEMA = {"k": {"kind": "dense", "dtype": "int32", "shape": []},
                "f": {"kind": "dense", "dtype": "float32", "shape": [3]},
                "s": {"kind": "str", "max_len": 24}}

SPECS = {
    "columns": {"kind": "columns", "capacity": 16, "str_max_len": 64,
                "columns": {"v": np.arange(100, dtype=np.int32),
                            "w": np.zeros((100, 2), np.float32),
                            "t": [b"x"] * 100}},
    "columns_rows": {"kind": "columns", "capacity": 16, "rows": 90,
                     "str_max_len": 8,
                     "columns": {"v": np.arange(100, dtype=np.int64)}},
    "text_rows": {"kind": "text", "paths": ["a.txt"], "column": "line",
                  "max_line_len": 80, "rows": 321, "capacity": 41},
    "text_no_rows": {"kind": "text", "paths": ["a.txt"], "column": "ln",
                     "max_line_len": 80, "capacity": 41},
    "store_schema": {"kind": "store", "path": "s", "capacity": 40,
                     "rows": 300, "schema": STORE_SCHEMA},
    "store_no_schema": {"kind": "store", "path": "s", "capacity": 40},
    "resident": {"kind": "resident", "token": "t", "capacity": 12},
    "unknown": {"kind": "mystery", "capacity": 5},
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_source_state_equals_jax(name):
    spec = SPECS[name]
    got = tcost._source_state(DeferredSource(spec), P)
    want = jcost._source_state(JDeferred(spec), P, JJobConfig())
    assert _state(got) == _state(want)


def test_columns_spec_is_exact():
    """The fault this repairs: a columns spec was an opaque source
    (``rows=[0, capacity x P]``, no schema, approximate)."""
    s = tcost._source_state(DeferredSource(SPECS["columns"]), P)
    assert (s.rows.lo, s.rows.hi, s.approx) == (100, 100, False)
    assert s.schema["v"].dtype == "int32"
    assert s.schema["t"].kind == "str" and s.schema["t"].max_len == 64


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_store_stream_spec_ends_the_pass(pkg):
    spec = {"kind": "store_stream", "path": "s", "chunk_rows": 64,
            "capacity": 64}
    if pkg == "port":
        with pytest.raises(tcost._Streamed):
            tcost._source_state(DeferredSource(spec), P)
    else:
        with pytest.raises(jcost._Streamed):
            jcost._source_state(JDeferred(spec), P, JJobConfig())


@pytest.fixture(scope="module")
def cluster():
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    cl = LocalCluster(n_processes=2, devices_per_process=4, device="cpu")
    yield cl
    cl.shutdown()
    if old is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = old


def _rows_by_stage(rep):
    return [(s.stage, s.label, s.rows.lo, s.rows.hi, s.capacity,
             s.out_bytes.lo, s.out_bytes.hi, s.approx) for s in rep.stages]


def test_cluster_cost_equals_in_process(cluster, tmp_path):
    """The same queries priced on a gang Context (deferred specs) and on
    an in-process Context at P = 8 (device data) on the (dcn, dp) mesh
    whose levels a gang of two plans: the same stages, rows, capacities
    and bytes."""
    rng = np.random.default_rng(5)
    cols = {"k": rng.integers(0, 30, 1000).astype(np.int32),
            "v": rng.integers(0, 99, 1000).astype(np.int32)}
    store = str(tmp_path / "st")
    Context(device="cpu", nparts=P).from_columns(cols).to_store(store)
    text = tmp_path / "t.txt"
    text.write_text("".join(f"w{i % 13} x{i % 5}\n" for i in range(700)))
    gang = Context(cluster=cluster)
    local = Context(mesh=make_mesh("cpu", P, hosts=2))

    def queries(ctx):
        a = ctx.from_columns(cols)
        b = ctx.from_store(store)
        return [a.group_by(["k"], {"s": ("sum", "v")}),
                a.order_by([("v", False)]),
                b.join(a.where(lambda c: c["v"] > 3), ["k"]),
                ctx.read_text(str(text)).split_words(
                    "line", out_capacity=4096).group_by(
                    ["line"], {"n": ("count", None)})]

    for g, l in zip(queries(gang), queries(local)):
        gr, lr = g.cost(), l.cost()
        assert _rows_by_stage(gr) == _rows_by_stage(lr)
        assert not any(s.approx for s in gr.stages[:1])
