"""The names the port's subpackages export, and the ``data`` and
``analysis.cost`` helpers that came with them, against the JAX package.

Every name that a JAX subpackage's ``__init__`` binds (read from its
source) imports from the port's subpackage of the same name, as the
port's own object; the top-level package adds ``make_mesh``.  The
re-exports are lazy (``dryad_tpu_torch/_lazy.py``): importing a
subpackage loads nothing past the package itself
(``tests/test_torch_isolation.py`` checks that in a fresh interpreter).
``concat_batches`` (over the valid prefixes), ``Schema.of`` /
``empty_batch``, ``string_column_to_list``, the ``Batch`` column
accessors, ``StringColumn.gather`` and ``CostReport.bounds`` after a
JSON round trip equal the JAX package's on the same numpy input.
Tolerance: none; the columns are 32-bit or strings, which both packages
keep as they are."""

import ast
import importlib
import json
import os

import numpy as np
import pytest
import torch

import dryad_tpu
from dryad_tpu.data import columnar as jcol
from dryad_tpu_torch.data import columnar as tcol
from tests.torch_threads import one_torch_thread  # noqa: F401

SUBPACKAGES = ("api", "data", "exec", "io", "ops", "parallel", "plan",
               "utils")


def _bound_names(pkg: str) -> list:
    """The public names a JAX package's ``__init__`` binds by import."""
    path = os.path.join(os.path.dirname(dryad_tpu.__file__),
                        *pkg.split(".")[1:], "__init__.py")
    names = []
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [(a.asname or a.name).split(".")[0]
                      for a in node.names]
    return sorted(n for n in names if not n.startswith("_")
                  and n != "annotations")


def test_the_jax_subpackages_export_what_the_roadmap_lists():
    assert {s: _bound_names(f"dryad_tpu.{s}") for s in SUBPACKAGES} == {
        "api": ["Context", "Dataset"],
        "data": ["Batch", "Schema", "StringColumn", "batch_from_numpy",
                 "batch_to_numpy", "concat_batches",
                 "string_column_from_list", "string_column_to_list"],
        "exec": ["CapacityError", "Executor", "PData", "pdata_from_host",
                 "pdata_to_host"],
        "io": ["read_store", "store_meta", "write_store"],
        "ops": ["hashing", "kernels", "text"],
        "parallel": ["mesh", "shuffle"],
        "plan": ["StageGraph", "expr", "plan_query"],
        "utils": ["EventLog", "job_report"]}


@pytest.mark.parametrize("sub", ("",) + SUBPACKAGES)
def test_every_jax_name_imports_from_the_port(sub):
    jname = "dryad_tpu" + (f".{sub}" if sub else "")
    tname = "dryad_tpu_torch" + (f".{sub}" if sub else "")
    jmod, tmod = importlib.import_module(jname), importlib.import_module(
        tname)
    names = _bound_names(jname)
    assert names
    if sub:
        assert sorted(tmod.__all__) == names
    for name in names:
        got = getattr(tmod, name)
        ref = getattr(jmod, name)
        # the port's object of the same name and kind, from the port
        mod = getattr(got, "__name__", "") if isinstance(
            got, type(os)) else getattr(got, "__module__", "")
        assert mod.startswith("dryad_tpu_torch."), (name, mod)
        assert isinstance(got, type(os)) == isinstance(ref, type(os))
        assert getattr(got, "__name__", name).rsplit(".", 1)[-1] == \
            getattr(ref, "__name__", name).rsplit(".", 1)[-1]
        exec(f"from {tname} import {name}", {})
    assert set(names) <= set(dir(tmod))


def test_an_unknown_name_raises_attribute_error():
    import dryad_tpu_torch.io as tio
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        tio.nope


def _tables():
    rng = np.random.default_rng(3)
    words = [b"", b"a", b"bb", b"\xff\x00c", b"dddd" * 3]
    out = []
    for n, cap in ((7, 10), (0, 4), (12, 12), (5, 9)):
        out.append(({"k": rng.integers(-50, 50, n).astype(np.int32),
                     "v": rng.standard_normal(n).astype(np.float32),
                     "w": rng.integers(0, 9, (n, 3)).astype(np.int32),
                     "s": [words[i] for i in rng.integers(0, 5, n)]},
                    cap))
    return out


def _pair(cols, cap, count):
    """The same batch in both packages, its count below its capacity."""
    jb = jcol.batch_from_numpy(cols, capacity=cap, str_max_len=6) \
        .with_count(count)
    tb = tcol.batch_from_numpy(cols, capacity=cap, str_max_len=6,
                               device="cpu").with_count(count)
    return jb, tb


def _same_host(j, t):
    assert list(j) == list(t)
    for k in j:
        if isinstance(j[k], list):
            assert [bytes(x) for x in j[k]] == [bytes(x) for x in t[k]], k
        else:
            np.testing.assert_array_equal(np.asarray(j[k]), t[k],
                                          err_msg=k)


@pytest.mark.parametrize("capacity", [None, 40])
def test_concat_batches_equals_jax(capacity):
    pairs = [_pair(c, cap, max(len(c["k"]) - 2, 0))
             for c, cap in _tables()]
    j = jcol.concat_batches([p[0] for p in pairs], capacity=capacity)
    t = tcol.concat_batches([p[1] for p in pairs], capacity=capacity)
    assert t.capacity == j.capacity and int(t.count) == int(j.count)
    _same_host(jcol.batch_to_numpy(j), tcol.batch_to_numpy(t))
    with pytest.raises(ValueError):
        tcol.concat_batches([])


def _np_dtype(dt):
    return torch.empty(0, dtype=dt).numpy().dtype


def test_schema_of_and_empty_batch_equal_jax():
    cols, cap = _tables()[0]
    jb, tb = _pair(cols, cap, 5)
    js, ts = jcol.Schema.of(jb), tcol.Schema.of(tb)
    assert list(js.fields) == list(ts.fields)
    for k, jf in js.fields.items():
        tf = ts.fields[k]
        assert tf[0] == jf[0]
        if jf[0] == "str":
            assert tf[1] == jf[1]
        else:
            assert _np_dtype(tf[1]) == np.dtype(jf[1])
            assert tuple(tf[2]) == tuple(jf[2])
    je, te = js.empty_batch(11), ts.empty_batch(11, device="cpu")
    assert te.capacity == je.capacity == 11 and int(te.count) == 0
    assert tcol.Schema.of(te) == ts
    for k in je.names:
        jv, tv = je[k], te[k]
        if isinstance(jv, jcol.StringColumn):
            assert tuple(tv.data.shape) == tuple(jv.data.shape)
            assert not tv.data.any() and not tv.lengths.any()
        else:
            assert tuple(tv.shape) == tuple(jv.shape)
            assert _np_dtype(tv.dtype) == np.dtype(jv.dtype)
            assert not tv.any()


def test_batch_accessors_and_string_gather_equal_jax():
    cols, cap = _tables()[2]
    jb, tb = _pair(cols, cap, 9)
    assert tb.column("k") is tb["k"] is tb.columns["k"]
    idx = np.array([4, 0, 0, 11, 2], np.int32)
    js = jb["s"].gather(idx)
    ts = tb["s"].gather(torch.from_numpy(idx).long())
    assert jcol.string_column_to_list(js, 5) == \
        tcol.string_column_to_list(ts, 5)
    jr = jb.select_columns(["s", "k"]).rename({"k": "key"})
    tr = tb.select_columns(["s", "k"]).rename({"k": "key"})
    assert tr.names == jr.names == ["s", "key"]
    _same_host(jcol.batch_to_numpy(jr), tcol.batch_to_numpy(tr))


def test_cost_report_bounds_after_round_trip_equal_jax(devices8):
    """``CostReport.bounds`` of a hierarchical group-by's plan on a
    (dcn, dp) mesh, after ``to_json`` and ``from_payload``: the same
    (rows, out_bytes) intervals as the JAX report's, stage by stage."""
    import jax

    from dryad_tpu import Context as JContext
    from dryad_tpu.analysis.cost import estimate_query as jestimate
    from dryad_tpu.parallel.mesh import make_mesh as jmake_mesh
    from dryad_tpu_torch import Context
    from dryad_tpu_torch.analysis.cost import CostReport, estimate_query
    from dryad_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(4)
    cols = {"k": rng.integers(0, 40, 600).astype(np.int32),
            "v": rng.standard_normal(600).astype(np.float32)}

    def q(ctx):
        return ctx.from_columns(cols).where(_positive).group_by(
            ["k"], {"n": ("count", None), "s": ("sum", "v")})
    tctx = Context(mesh=make_mesh("cpu", 8, hosts=2))
    jctx = JContext(mesh=jmake_mesh(jax.devices(), hosts=2))
    rep = estimate_query(q(tctx).node, 8, hosts=tctx.hosts,
                         levels=tctx.levels)
    jrep = jestimate(q(jctx).node, 8, hosts=jctx.hosts, levels=jctx.levels)
    back = CostReport.from_payload(json.loads(rep.to_json()))
    assert json.loads(rep.to_json()) == rep.to_payload()
    sids = [s.stage for s in jrep.stages]
    assert [s.stage for s in back.stages] == sids and len(sids) == 2
    for sid in sids:
        got, want = back.bounds(sid), jrep.bounds(sid)
        assert got == rep.bounds(sid)
        assert [(i.lo, i.hi) for i in got] == [(i.lo, i.hi) for i in want]
    assert back.bounds(99) is None


def _positive(c):
    return c["v"] > -1.0
