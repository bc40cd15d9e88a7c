"""The segmented-scan kernel (``dryad_tpu_torch/ops/csrc/seg_scan.cu``)
behind ``hopper_kernels.seg_scan_multi`` and the group op's scan lowering
(``kernels._seg_scan_multi``, which routes between the kernel and
``hopper_kernels.seg_scan_multi_plain``).

On the CPU: the routing (CPU tensors and, inside ``shape_only()``, meta
tensors take the plain version and launch nothing; on the card a call
with a leaf the kernel neither takes nor widens raises), the lane
descriptors the wrapper hands the kernel and its widening of bool, 8- and
16-bit leaves (through a stand-in library that scans each described lane
with the plain version), the source's constants and device names, the
``seg_scan`` span, and the benchmark's reader ``seg_scan_device_pct``.

Marked ``card`` (they skip without a CUDA card): the kernel against the
plain version on the same CUDA inputs, integers, bool and min / max bit
for bit (signed zeros by the kernel's stated rule), float sums within 16
eps of their dtype x the sum of magnitudes and bit-identical from launch
to launch, at every tile boundary up to 22.5M rows, for every dtype the
kernel takes or widens; and ``group_aggregate`` over TPC-H Q1's and Q3's
aggregate sets and one of narrow and double columns on the card equal to
its CPU run.  This file does not import JAX, so the card tests run where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_seg_scan_kernel.py
"""

import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from dryad_tpu_torch.data import columnar as tcol
from dryad_tpu_torch.data.columnar import Batch, StringColumn, map_column
from dryad_tpu_torch.obs import trace
from dryad_tpu_torch.ops import _build
from dryad_tpu_torch.ops import hopper_kernels as hk
from dryad_tpu_torch.ops import kernels as tkern
from torch_threads import one_torch_thread  # noqa: F401

SOURCE = Path(hk.__file__).resolve().parent / "csrc" / "seg_scan.cu"
EPS = {torch.float64: 2.0**-53, torch.float32: 2.0**-24,
       torch.float16: 2.0**-11, torch.bfloat16: 2.0**-8}
TILE = hk._SEG_TILE
NP = {0: np.int32, 1: np.int64, 2: np.float32, 3: np.float64}
OPS = {0: torch.add, 1: torch.minimum, 2: torch.maximum}
# leaves the wrapper widens for the kernel, and what it describes them as
WIDENED = {"float64": (torch.float64, 3), "int16": (torch.int16, 0),
           "int8": (torch.int8, 0), "uint8": (torch.uint8, 0),
           "bool": (torch.bool, 0), "float16": (torch.float16, 2),
           "bfloat16": (torch.bfloat16, 2)}


class Collector(list):
    """An in-memory span sink at level 2."""

    level = 2

    def __call__(self, e):
        if e.get("event") == "span":
            self.append(e)


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _leaves(n, seed=3, p=0.01):
    """A mixed call: int64 sums, int32 min, float32 max and sums, and an
    [n, 3] int64 view of every other column of a wider matrix."""
    rng = np.random.default_rng(seed)
    starts = torch.from_numpy(rng.random(n) < p)
    i64 = torch.from_numpy(rng.integers(-2**40, 2**40, n))
    i32 = torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32))
    f32 = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    wide = torch.from_numpy(rng.integers(-9, 9, (n, 6)))
    leaves = [(i64, torch.add), (i32, torch.minimum), (f32, torch.maximum),
              (f32, torch.add), (wide[:, ::2], torch.add)]
    return leaves, starts


def _narrow(dtype, n, dev="cpu", seed=4):
    """Values of ``dtype`` over n rows: the whole range of a narrow
    integer (so sums wrap), 0 / 1 for bool, normal floats with a NaN in
    about one row of 500."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(n, generator=g, device=dev) < 0.3
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max + 1, (n,), dtype=dtype,
                             device=dev, generator=g)
    x = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
    nan = torch.rand(n, generator=g, device=dev) < 2e-3
    return torch.where(nan, float("nan"), x).to(dtype)


def _equal(got, want):
    return len(got) == len(want) and all(
        g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
        for g, w in zip(got, want))


def _check(got, want, leaves, starts, exact_float_sums=False):
    """Integers, bool and min / max bit for bit (NaN where the plain
    version has NaN; a zero's sign may follow the kernel's rule instead);
    float sums NaN where the plain version's are, else within 16 eps of
    the dtype x the running sum of magnitudes (summed in float64)."""
    assert len(got) == len(want) == len(leaves)
    for g, w, (v, op) in zip(got, want, leaves):
        assert g.shape == w.shape and g.dtype == w.dtype
        g, w = g.cpu(), w.cpu()
        if not g.dtype.is_floating_point:
            assert torch.equal(g, w)
        elif op is torch.add:
            mag = hk.seg_scan_multi_plain([(v.cpu().double().abs(),
                                            torch.add)], starts.cpu())[0]
            err = (g.double() - w.double()).abs()
            gn = torch.isnan(g)
            assert torch.equal(gn, torch.isnan(w))
            assert bool((gn | (err <= 16 * EPS[g.dtype] * mag)).all())
            if exact_float_sums:
                assert torch.equal(g, w)
        else:
            gn, wn = torch.isnan(g), torch.isnan(w)
            assert torch.equal(gn, wn)
            # equal values (+0.0 == -0.0); nonzero equal values have
            # equal bits
            assert torch.equal(torch.where(gn, 0.0, g),
                               torch.where(wn, 0.0, w))


# ---------------------------------------------------------------------------
# the CPU


def _constants():
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", SOURCE.read_text())}


def test_source_constants_mirror_the_wrapper():
    c = _constants()
    assert hk._SEG_TILE == c["kThreads"] * c["kRows"]
    assert hk._SEG_MAX_LANES == c["kMaxLanes"]
    assert hk._SEG_KIND == {torch.int32: c["kI32"], torch.int64: c["kI64"],
                            torch.float32: c["kF32"],
                            torch.float64: c["kF64"]}
    assert hk._SEG_OPS == {torch.add: c["kAdd"], torch.minimum: c["kMin"],
                           torch.maximum: c["kMax"]}
    assert set(hk._SEG_WIDEN.values()) <= set(hk._SEG_KIND)
    assert "seg_scan" in _build.KERNELS and "seg_scan" in hk.launches


def test_device_names_are_none_the_benchmark_reckons():
    """The kernels' device functions match no kernel name of
    ``portbench/roofline.py`` (which would count them as another kernel),
    and the kernel is never captured."""
    from portbench import roofline
    names = re.findall(r"__global__ void __launch_bounds__\(\w+\)\s+(\w+)\(",
                       SOURCE.read_text())
    assert sorted(names) == ["seg_tile_apply", "seg_tile_carry",
                             "seg_tile_reduce"]
    subs = [s for v in roofline.DEVICE_NAMES.values() for s in v]
    assert not [n for n in names if any(s in n for s in subs)]
    assert "_capture" not in hk.seg_scan_multi.__code__.co_names


def test_cpu_takes_the_plain_version_and_launches_nothing(monkeypatch):
    leaves, starts = _leaves(3 * TILE + 11)
    monkeypatch.setattr(_build, "library", _no_library)
    hk.reset_launches()
    got = tkern._seg_scan_multi(leaves, starts)
    assert _equal(got, hk.seg_scan_multi_plain(leaves, starts))
    assert hk.launches["seg_scan"] == 0
    # the int64 sums: each segment's running sum, by a loop on the host
    seg = torch.cumsum(starts.long(), 0)
    x = leaves[0][0]
    for i in (0, 100, 5000, starts.shape[0] - 1):
        rows = (seg == seg[i]) & (torch.arange(starts.shape[0]) <= i)
        assert int(got[0][i]) == int(x[rows].sum())
    with pytest.raises(ValueError):
        hk.seg_scan_multi(leaves, starts)     # the kernel takes no CPU call


def test_meta_takes_the_plain_version_inside_shape_only():
    n = 100
    leaves = [(torch.empty(n, dtype=torch.int32, device="meta"), torch.add),
              (torch.empty(n, dtype=torch.int64, device="meta"), torch.add),
              (torch.empty((n, 3), device="meta"), torch.maximum)]
    starts = torch.empty(n, dtype=torch.bool, device="meta")
    hk.reset_launches()
    with hk.shape_only():
        got = tkern._seg_scan_multi(leaves, starts)
    assert [(t.device.type, tuple(t.shape), t.dtype) for t in got] == [
        ("meta", (n,), torch.int32), ("meta", (n,), torch.int64),
        ("meta", (n, 3), torch.float32)]
    assert hk.launches["seg_scan"] == 0
    with pytest.raises(ValueError):
        tkern._seg_scan_multi(leaves, starts)


def _no_library(name):
    raise AssertionError(f"{name}: launched for a call the kernel does not "
                         f"take")


@pytest.mark.parametrize("leaf", ["uint32", "uint64", "complex64",
                                  "lambda_op", "3d", "rows_differ",
                                  "string", "int_flags"])
def test_a_leaf_the_kernel_does_not_take_raises_on_the_card(
        leaf, monkeypatch):
    """With the card pretended, a call with one leaf the kernel does not
    take (a dtype it neither takes nor widens, another op or shape, a
    string column) or flags that are not bool raises before anything is
    launched: no CUDA call goes back to the plain version."""
    n = TILE + 3
    leaves, starts = _leaves(n)
    x = leaves[0][0]
    bad = {"uint32": (x.to(torch.uint32), torch.add),
           "uint64": (x.to(torch.uint64), torch.maximum),
           "complex64": (x.to(torch.complex64), torch.add),
           "lambda_op": (x, lambda a, b: a + b),
           "3d": (x.view(n, 1, 1), torch.add),
           "rows_differ": (x[:-1], torch.add),
           "string": (StringColumn(torch.zeros((n, 4), dtype=torch.uint8),
                                   torch.zeros(n, dtype=torch.int32)),
                      torch.minimum),
           "int_flags": None}[leaf]
    call = leaves + ([bad] if bad else [])
    flags = starts.to(torch.int32) if leaf == "int_flags" else starts
    monkeypatch.setattr(hk, "_on_card", lambda name, *ts: True)
    monkeypatch.setattr(_build, "library", _no_library)
    hk.reset_launches()
    with pytest.raises(ValueError, match="seg_scan"):
        tkern._seg_scan_multi(call, flags)
    assert hk.launches["seg_scan"] == 0


def _view(ptr, n, stride, dtype):
    """n elements of ``dtype`` from address ``ptr``, ``stride`` bytes
    apart, as a numpy view."""
    n, stride = int(n), int(stride)
    es = np.dtype(dtype).itemsize
    buf = (ctypes.c_char * ((n - 1) * stride + es)).from_address(int(ptr))
    return np.ndarray((n,), dtype=dtype, buffer=buf, strides=(stride,))


def _stand_in(calls):
    """A library whose ``dryad_seg_scan`` scans each described lane with
    the plain version, reading and writing through the descriptors'
    pointers and strides, and records each launch's descriptors."""
    def launch(desc, nlanes, n, flags, agg, agg_start, stream):
        d = np.ctypeslib.as_array(
            (ctypes.c_longlong * (7 * nlanes)).from_address(desc)
        ).reshape(nlanes, 7).copy()
        calls.append(d)
        st = torch.from_numpy(_view(flags, n, 1, np.bool_).copy())
        for ip, op_, ist, ost, kind, op, _vec in d:
            x = torch.from_numpy(_view(ip, n, ist, NP[kind]).copy())
            y = hk.seg_scan_multi_plain([(x, OPS[op])], st)[0]
            _view(op_, n, ost, NP[kind])[:] = y.numpy()
        return 0
    return types.SimpleNamespace(dryad_seg_scan=launch)


def _pretend_card(monkeypatch, calls):
    monkeypatch.setattr(hk, "_on_card", lambda name, *ts: True)
    monkeypatch.setattr(hk, "_stream", lambda t: 0)
    monkeypatch.setattr(_build, "library", lambda name: _stand_in(calls))


@pytest.mark.parametrize("case", ["mixed", "20_lanes", "one_row"])
def test_stand_in_kernel_gives_the_plain_versions_bits(case, monkeypatch):
    """The descriptors: one lane per column of an [n, k] leaf at its byte
    strides, kinds and ops as the source numbers them, vector access only
    for contiguous aligned lanes, one launch per 16 lanes; a stand-in that
    scans each described lane as the plain version does gives the plain
    version's outputs."""
    n = 1 if case == "one_row" else 2 * TILE + 7
    leaves, starts = _leaves(n)
    if case == "20_lanes":
        leaves = [(leaves[0][0] + i, torch.add) for i in range(20)]
    calls = []
    _pretend_card(monkeypatch, calls)
    hk.reset_launches()
    got = tkern._seg_scan_multi(leaves, starts)
    assert _equal(got, hk.seg_scan_multi_plain(leaves, starts))
    d = np.concatenate(calls)
    assert [len(c) for c in calls] == ([16, 4] if case == "20_lanes"
                                       else [7])
    assert hk.launches["seg_scan"] == len(calls)
    if case != "20_lanes":
        # kinds and ops: i64 add, i32 min, f32 max, f32 add, 3 x i64 add
        assert d[:, 4].tolist() == [1, 0, 2, 2, 1, 1, 1]
        assert d[:, 5].tolist() == [0, 1, 2, 0, 0, 0, 0]
        # the view's columns: 16 bytes apart, 48 bytes a row; written
        # contiguous, 24 bytes a row
        wide = leaves[4][0]
        assert d[4:, 0].tolist() == [wide.data_ptr() + 16 * j
                                     for j in range(3)]
        assert d[4:, 2].tolist() == [48] * 3 and d[4:, 3].tolist() == [24] * 3
        assert d[4:, 6].tolist() == [0] * 3
        assert d[0, 2] == d[0, 3] == 8
        assert d[0, 6] == int(leaves[0][0].data_ptr() % 16 == 0
                              and got[0].data_ptr() % 16 == 0)


@pytest.mark.parametrize("name", sorted(WIDENED))
def test_narrow_and_double_leaves_scan_on_the_card(name, monkeypatch):
    """float64 leaves are float64 lanes; bool, 8- and 16-bit integers are
    scanned as int32 lanes and 16-bit floats as float32 ones, then
    narrowed back.  Through the stand-in: add, min and max (an [n, 2]
    view among them) give the plain version's bits in the leaf's dtype
    (wrapping adds, bool's add an any), 16-bit float sums within their
    rounding."""
    dtype, kind = WIDENED[name]
    n = 2 * TILE + 9
    _, starts = _leaves(n)
    x = _narrow(dtype, 2 * n).view(n, 2)
    leaves = [(x[:, 0], torch.add), (x[:, 1], torch.minimum),
              (x[:, 0], torch.maximum), (x, torch.add)]
    calls = []
    _pretend_card(monkeypatch, calls)
    got = tkern._seg_scan_multi(leaves, starts)
    want = hk.seg_scan_multi_plain(leaves, starts)
    assert [len(c) for c in calls] == [5]
    assert calls[0][:, 4].tolist() == [kind] * 5
    assert calls[0][:, 5].tolist() == [0, 1, 2, 0, 0]
    if dtype.is_floating_point:
        _check(got, want, leaves, starts)
    else:
        assert _equal(got, want)


def test_no_rows_and_no_leaves_launch_nothing(monkeypatch):
    monkeypatch.setattr(hk, "_on_card", lambda name, *ts: True)
    monkeypatch.setattr(_build, "library", _no_library)
    leaves, starts = _leaves(0)
    got = hk.seg_scan_multi(leaves, starts)
    assert [tuple(t.shape) for t in got] == [(0,), (0,), (0,), (0,),
                                             (0, 3)]
    assert hk.seg_scan_multi([], _leaves(9)[1]) == []


def _group_batch(n=3000, cap=3100, seed=5):
    rng = np.random.default_rng(seed)
    cols = {"k": rng.integers(0, 40, n).astype(np.int64),
            "v": rng.integers(-10**12, 10**12, n).astype(np.int64)}
    return tcol.batch_from_numpy(cols, capacity=cap, device="cpu")


@pytest.mark.parametrize("tracing", [True, False])
def test_group_scan_opens_one_seg_scan_span(tracing, monkeypatch):
    """With tracing on, the group op's scan lowering opens one
    ``seg_scan`` span (``rows``: the capacity; ``cols``: the count and
    two leaves; ``route``); with tracing off none is built."""
    b = _group_batch()
    aggs = {"n": ("count", None), "s": ("sum", "v"), "lo": ("min", "v"),
            "m": ("mean", "v")}
    sink = Collector()
    if tracing:
        trace.install(sink)
    else:
        def refuse(*a, **k):
            raise AssertionError("a span built with tracing off")
        monkeypatch.setattr(trace, "scope", refuse)
    try:
        out = tkern._group_aggregate_scan(b, ["k"], aggs)
    finally:
        if tracing:
            trace.install(None)
    assert int(out.count) == 40
    got = [(s["name"], s["attrs"]) for s in sink if s["name"] == "seg_scan"]
    assert got == ([("seg_scan", {"rows": 3100, "cols": 3,
                                  "route": "plain"})] if tracing else [])


def _window(seg_spans=True):
    """A span window: one job, an op.group with a seg_scan inside it,
    device records at known times (after
    portbench/tests/test_portbench_new_cells.py)."""
    from portbench import spantrace
    spans = [{"name": "query", "kind": "query", "span": "q",
              "start_ns": 0, "end_ns": 100},
             {"name": "op.group", "kind": "op", "span": "g", "parent": "q",
              "start_ns": 10, "end_ns": 90}]
    if seg_spans:
        spans.append({"name": "seg_scan", "kind": "op", "span": "s",
                      "parent": "g", "start_ns": 30, "end_ns": 60,
                      "attrs": {"rows": 8, "cols": 2, "route": "kernel"}})
    records = [("k", 0, 10, 1), ("k", 20, 30, 2), ("k", 40, 70, 3),
               ("k", 80, 90, 4)]
    launches = {1: 5, 2: 15, 3: 35, 4: 75}
    return spantrace.joined(spans, {"records": records, "clock": None,
                                    "launches": launches, "syncs": []},
                            0, 100)


def test_seg_scan_device_pct_reads_the_seg_scan_spans():
    """Busy 60 ns, 30 of them launched inside the seg_scan span: 50 %;
    a window without such a span (the parent) reads None, as does a run
    without a window."""
    from portbench import bench
    reader = bench.reader("seg_scan_device_pct")
    rec = {"spans": _window(), "trace": {"records": [], "least": {}}}
    assert reader.read(rec) == pytest.approx(50.0)
    assert reader.read({"spans": _window(seg_spans=False),
                        "trace": None}) is None
    assert reader.read({"spans": None, "trace": None}) is None


def test_seg_scan_device_pct_is_an_operators_metric_of_q1_and_q3():
    import json
    spec = json.loads((Path(__file__).resolve().parents[1]
                       / "BENCHMARK.json").read_text())
    m = [e for e in spec["per_layer"] if e["name"] == "seg_scan_device_pct"]
    assert m == [{"name": "seg_scan_device_pct", "unit": "%",
                  "better": "lower", "source": "device_trace",
                  "layer": "operators", "moves": "rows_per_s",
                  "workloads": ["tpch.q3", "tpch.q1"]}]


# ---------------------------------------------------------------------------
# the card


def _rule_zeros(v, starts, op):
    """The sign of each zero output by the kernel's rule, by a sequential
    fold on the host: a min over a run holding -0.0 is -0.0, a max over one
    holding +0.0 is +0.0."""
    out, acc = [], None
    for x, s in zip(v.tolist(), starts.tolist()):
        if s or acc is None:
            acc = x
        elif op is torch.minimum:
            acc = -0.0 if (acc == x == 0 and (np.signbit(acc)
                                              or np.signbit(x))) \
                else min(acc, x)
        else:
            acc = 0.0 if (acc == x == 0 and not (np.signbit(acc)
                                                 and np.signbit(x))) \
                else max(acc, x)
        out.append(acc)
    return np.signbit(np.array(out, np.float32))


def _case(n, dev, pattern, seed):
    """Leaves over n rows on ``dev``: the count leaf, int32 and int64 sums
    (int64 near the wrap), int32, int64 and float32 min / max with NaN
    rows, float32 sums, an [n, 3] view; flags by ``pattern``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if pattern == "one_segment":
        starts = torch.zeros(n, dtype=torch.bool, device=dev)
    elif pattern == "every_row":
        starts = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        starts = torch.rand(n, generator=g, device=dev) < 2e-4
    cnt = (torch.arange(n, device=dev) < max(n - 17, 0)).to(torch.int32)
    i32 = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                        device=dev, generator=g)
    i64 = torch.randint(2**62, 2**63 - 1, (n,), dtype=torch.int64,
                        device=dev, generator=g)
    f32 = torch.randn(n, generator=g, device=dev)
    fmm = torch.where(torch.rand(n, generator=g, device=dev) < 1e-4,
                      float("nan"), f32)
    wide = torch.randint(-2**40, 2**40, (n, 5), dtype=torch.int64,
                         device=dev, generator=g)
    leaves = [(cnt, torch.add), (i32, torch.add), (i64, torch.add),
              (i32, torch.minimum), (i32, torch.maximum),
              (i64, torch.minimum), (i64, torch.maximum),
              (fmm, torch.minimum), (fmm, torch.maximum), (f32, torch.add),
              (wide[:, 1:4], torch.maximum)]
    return leaves, starts


@pytest.mark.card
@pytest.mark.parametrize("n,pattern", [
    (n, p) for n in (0, 1, TILE - 1, TILE, TILE + 1, 2**24 + 3, 22_500_000)
    for p in ("random", "one_segment", "every_row")
    if n < 2**24 or p != "every_row"])
def test_card_kernel_equals_plain(card, n, pattern):
    leaves, starts = _case(n, card, pattern, seed=n % 1000 + 7)
    hk.reset_launches()
    got = tkern._seg_scan_multi(leaves, starts)
    torch.cuda.synchronize()
    assert hk.launches["seg_scan"] == (1 if n else 0)
    want = hk.seg_scan_multi_plain(leaves, starts)
    _check(got, want, leaves, starts,
           exact_float_sums=pattern == "every_row")


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(WIDENED))
@pytest.mark.parametrize("pattern", ["random", "one_segment"])
def test_card_narrow_and_double_leaves_equal_plain(card, name, pattern):
    """float64, int16, int8, uint8, bool, float16 and bfloat16 leaves
    (add, min, max; an [n, 2] view) on the card against the plain version
    on the same CUDA inputs: bit for bit but for float sums, which lie
    within 16 eps of their dtype x the sum of magnitudes."""
    dtype, _kind = WIDENED[name]
    n = 3 * 2**20 + 5
    if pattern == "one_segment" and dtype in (torch.float16,
                                              torch.bfloat16):
        n = 4 * TILE + 5        # a 16-bit float sum of 3M rows overflows
    starts = (torch.zeros(n, dtype=torch.bool, device=card)
              if pattern == "one_segment" else
              torch.rand(n, device=card) < 2e-4)
    x = _narrow(dtype, 2 * n, card).view(n, 2)
    leaves = [(x[:, 0], torch.add), (x[:, 1], torch.minimum),
              (x[:, 0], torch.maximum), (x, torch.add)]
    hk.reset_launches()
    got = tkern._seg_scan_multi(leaves, starts)
    torch.cuda.synchronize()
    assert hk.launches["seg_scan"] == 1
    _check(got, hk.seg_scan_multi_plain(leaves, starts), leaves, starts)


@pytest.mark.card
def test_card_float_sums_bit_identical_over_five_launches(card):
    leaves, starts = _case(22_500_000, card, "random", seed=11)
    x = leaves[9][0]
    f = [(x, torch.add), (x.double(), torch.add)]
    first = hk.seg_scan_multi(f, starts)
    for _ in range(4):
        again = hk.seg_scan_multi(f, starts)
        assert torch.equal(first[0].view(torch.int32),
                           again[0].view(torch.int32))
        assert torch.equal(first[1].view(torch.int64),
                           again[1].view(torch.int64))


@pytest.mark.card
def test_card_signed_zeros_follow_the_kernels_rule(card):
    base = torch.tensor([0.0, -0.0, 0.0, 1.0, -0.0, 0.0, -1.0, 0.0],
                        dtype=torch.float32)
    st = torch.zeros(700 * base.shape[0], dtype=torch.bool)
    st[::301] = True
    for dtype in (torch.float32, torch.float64):
        v = base.repeat(700).to(dtype)
        got = hk.seg_scan_multi([(v.to(card), torch.minimum),
                                 (v.to(card), torch.maximum)], st.to(card))
        want = hk.seg_scan_multi_plain([(v, torch.minimum),
                                        (v, torch.maximum)], st)
        for g, w, op in zip(got, want, (torch.minimum, torch.maximum)):
            g = g.cpu()
            assert torch.equal(g, w)
            assert np.array_equal(np.signbit(g.numpy()),
                                  _rule_zeros(v, st, op))


@pytest.mark.card
def test_card_more_lanes_than_a_launch_carries(card):
    n = 3 * TILE + 5
    g = torch.Generator(device=card).manual_seed(2)
    starts = torch.rand(n, generator=g, device=card) < 1e-3
    leaves = [(torch.randint(-2**63, 2**63 - 1, (n,), dtype=torch.int64,
                             device=card, generator=g), torch.add)
              for _ in range(20)]
    hk.reset_launches()
    got = hk.seg_scan_multi(leaves, starts)
    assert hk.launches["seg_scan"] == 2
    assert _equal(got, hk.seg_scan_multi_plain(leaves, starts))


def _to(batch, device):
    return Batch({k: map_column(c, lambda t: t.to(device))
                  for k, c in batch.columns.items()},
                 batch.count.to(device))


def _sorted_rows(b, keys):
    """The valid rows' columns on the host, in key order."""
    n = int(b.count)
    cols = {k: (v.data[:n].cpu() if isinstance(v, StringColumn)
                else v[:n].cpu()) for k, v in b.columns.items()}
    order = np.lexsort([cols[k].reshape(n, -1)[:, 0].numpy()
                        for k in reversed(keys)])
    return {k: v[torch.from_numpy(order)] for k, v in cols.items()}


@pytest.mark.card
@pytest.mark.parametrize("query", ["q1", "q3", "narrow"])
def test_card_group_aggregate_equals_its_cpu_run(card, query):
    """``group_aggregate`` over Q1's aggregate set (two one-byte string
    keys; sums of five int64 decimals, three means, a count), Q3's (three
    integer keys, an int64 sum) and one of narrow and double columns
    (float64 min and max, an int16 sum, an int8 max) at 2**20 rows in a
    padded capacity: the card's groups equal the CPU's exactly, through
    the kernel."""
    rng = np.random.default_rng(27)
    n, cap = 1 << 20, (1 << 20) + 4099
    if query == "q1":
        cols = {"flag": [rng.choice(["A", "N", "R"]) for _ in range(n)],
                "status": [rng.choice(["F", "O"]) for _ in range(n)]}
        for c in ("qty", "price", "disc", "disc_price", "charge"):
            cols[c] = rng.integers(0, 10**12, n).astype(np.int64)
        keys = ["flag", "status"]
        aggs = {"sum_qty": ("sum", "qty"), "sum_price": ("sum", "price"),
                "sum_disc_price": ("sum", "disc_price"),
                "sum_charge": ("sum", "charge"),
                "avg_qty": ("mean", "qty"), "avg_price": ("mean", "price"),
                "avg_disc": ("mean", "disc"), "n": ("count", None)}
    elif query == "narrow":
        cols = {"g": rng.integers(0, 1000, n).astype(np.int32),
                "d": rng.standard_normal(n),
                "h": rng.integers(-2**15, 2**15, n).astype(np.int16),
                "b": rng.integers(-128, 128, n).astype(np.int8)}
        keys = ["g"]
        aggs = {"lo": ("min", "d"), "hi": ("max", "d"), "s16": ("sum", "h"),
                "m8": ("max", "b"), "n": ("count", None)}
    else:
        cols = {"okey": rng.integers(0, 200_000, n).astype(np.int32),
                "odate": rng.integers(8000, 9000, n).astype(np.int32),
                "prio": rng.integers(0, 1, n).astype(np.int32),
                "rev": rng.integers(0, 10**9, n).astype(np.int64)}
        keys = ["okey", "odate", "prio"]
        aggs = {"revenue": ("sum", "rev")}
    cpu = tcol.batch_from_numpy(cols, capacity=cap, str_max_len=1,
                                device="cpu")
    want = tkern.group_aggregate(cpu, keys, aggs)
    hk.reset_launches()
    got = tkern.group_aggregate(_to(cpu, card), keys, aggs)
    torch.cuda.synchronize()
    assert hk.launches["seg_scan"] >= 1
    assert int(got.count) == int(want.count)
    a, b = _sorted_rows(got, keys), _sorted_rows(want, keys)
    for k in b:
        assert torch.equal(a[k], b[k]), k
