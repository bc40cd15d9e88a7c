"""The key hash kernel (``dryad_tpu_torch/ops/csrc/hash_keys.cu``) behind
``hashing.hash_batch_keys``.

On the CPU: the routing (CPU columns take the plain version and launch
nothing, meta columns inside ``shape_only()`` give meta lanes, other
devices and mixes raise), the ``hash`` span's ``route``, the column
descriptors the wrapper hands the kernel, and the source's constants
against ``hashing.py`` (a uint32 model of the kernel's chain, built from
the constants read out of the source, gives the plain version's bits).

Marked ``card`` (they skip without a CUDA card): the kernel's lanes
bit-identical to the plain version on the same data on the CPU, and to
the JAX package's through ``hash_key_cases.JAX_DIGESTS``, for every kind
of key; one launch per call of up to 32 key columns, one per 32 beyond.
This file does not import JAX, so the card tests run where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_hash_kernel.py
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
from dryad_tpu_torch.ops import hashing as th
from dryad_tpu_torch.ops import hopper_kernels as hk
import hash_key_cases as hc
from torch_threads import one_torch_thread  # noqa: F401

SOURCE = Path(th.__file__).resolve().parent / "csrc" / "hash_keys.cu"
M32 = 0xFFFFFFFF


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


def _batch(kind, device="cpu"):
    cols = hc.columns(kind)
    return tcol.batch_from_numpy(cols, capacity=hc.capacity(kind, cols),
                                 str_max_len=hc.CASES[kind][1],
                                 device=device), list(cols)


def _to(batch, device):
    return Batch({k: map_column(c, lambda t: t.to(device))
                  for k, c in batch.columns.items()},
                 batch.count.to(device))


def _constants():
    src = SOURCE.read_text()
    c = {k: int(v, 16) for k, v in re.findall(
        r"constexpr unsigned (k\w+) = 0x([0-9A-Fa-f]+)u;", src)}
    c.update({k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)})
    return c


# ---------------------------------------------------------------------------
# the CPU


def test_source_sizes_and_kinds_mirror_the_wrapper():
    c = _constants()
    assert c["kMaxHashLen"] == th._MAX_HASH_LEN == 512
    assert c["kMaxCols"] == th._MAX_KEY_COLS
    names = {torch.int8: "kI8", torch.uint8: "kU8", torch.int16: "kI16",
             torch.uint16: "kU16", torch.int32: "kI32", torch.uint32: "kI32",
             torch.int64: "kI64", torch.uint64: "kI64", torch.bool: "kBool",
             torch.float16: "kF16", torch.bfloat16: "kBF16",
             torch.float32: "kF32", torch.float64: "kF64"}
    assert {dt: c[n] for dt, n in names.items()} == th._KIND
    assert c["kStr"] == th._KIND_STR
    assert len({c[n] for n in names.values()} | {c["kStr"]}) == 12


def _mix(x, c1, c2):
    x = x ^ (x >> 16)
    x = (x * c1) & M32
    x = x ^ (x >> 13)
    x = (x * c2) & M32
    return x ^ (x >> 16)


def _model(cols, c):
    """The kernel's chain in Python integers, with the source's constants:
    int32 and string columns of the CPU batch, row by row."""
    hm, lm = (c["kHiMul1"], c["kHiMul2"]), (c["kLoMul1"], c["kLoMul2"])

    def comb(h, l, g, k):
        def one(a, b, m):
            return _mix(a ^ ((b + c["kGolden"] + (a << 6) + (a >> 2)) & M32),
                        *m)
        return one(h, g, hm), one(l, k, lm)

    w1, w2 = (w.astype(np.int64) for w in th._byte_weights())
    out = []
    for r in range(cols[0].capacity if isinstance(cols[0], StringColumn)
                   else cols[0].shape[0]):
        acc = None
        for col in cols:
            if isinstance(col, StringColumn):
                n = int(col.lengths[r])
                m = min(max(n, 0), col.max_len, c["kMaxHashLen"])
                b = col.data[r, :m].numpy().astype(np.int64) + 1
                s1 = int((b * w1[:m]).sum()) & M32
                s2 = int((b * w2[:m]).sum()) & M32
                u = n & M32
                ch, cl = comb(_mix(s1, c["kLoMul1"], c["kHiMul1"]),
                              _mix(s2, c["kLoMul2"], c["kHiMul2"]),
                              _mix(u, *hm), _mix(u, *lm))
            else:
                ch = cl = 0
                b = int(col[r]) & M32
                ch, cl = comb(ch, cl, _mix(b, *hm), _mix(b, *lm))
            acc = (ch, cl) if acc is None else comb(*acc, ch, cl)
        out.append(acc)
    return out


def test_the_sources_chain_gives_the_plain_versions_bits():
    """The constants read from the CUDA source, in the order the source
    uses them, give hash_columns' lanes: three int32 keys (Q3's group-by
    shape) and a string key beside an int32 one."""
    c = _constants()
    rng = np.random.RandomState(5)
    ints = {k: rng.randint(-2**31, 2**31 - 1, 300).astype(np.int32)
            for k in "abc"}
    strs = {"s": hc._strings(rng, 300), "j": ints["a"]}
    for cols in (ints, strs):
        b = tcol.batch_from_numpy(cols, str_max_len=24, device="cpu")
        hi, lo = th.hash_columns([b.columns[k] for k in cols])
        model = _model([b.columns[k] for k in cols], c)
        assert [(int(h), int(l)) for h, l in zip(hi, lo)] == model


def test_cpu_batches_take_the_plain_version_and_launch_nothing(monkeypatch):
    def no_build(*a, **kw):
        raise AssertionError("a CPU batch reached the kernel build")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    hk.reset_launches()
    for kind in ("i32", "multi", "i64x3", "zero", "wide40"):
        b, keys = _batch(kind)
        hi, lo = th.hash_batch_keys(b, keys)
        want = th.hash_columns([b.columns[k] for k in keys])
        assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
        assert hi.dtype == lo.dtype == torch.int64
    assert sum(hk.launches.values()) == 0
    assert "hash_keys" in hk.launches


def test_meta_batches_take_the_plain_version_inside_shape_only():
    b, keys = _batch("multi")
    meta = _to(b, "meta")
    with hk.shape_only():
        hi, lo = th.hash_batch_keys(meta, keys)
    assert hi.is_meta and lo.is_meta
    assert hi.shape == lo.shape == (b.capacity,)
    assert hi.dtype == lo.dtype == torch.int64
    with pytest.raises(ValueError, match="unsupported device"):
        th.hash_batch_keys(meta, keys)


def test_mixed_devices_and_no_keys_raise():
    b, _ = _batch("multi")
    mixed = Batch({"k": b.columns["k"], "j": b.columns["j"].to("meta")},
                  b.count)
    with hk.shape_only(), pytest.raises(ValueError, match="different"):
        th.hash_batch_keys(mixed, ["k", "j"])
    with pytest.raises(ValueError, match="at least one"):
        th.hash_batch_keys(b, [])


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_hash_span_carries_its_route(route, monkeypatch):
    """A CPU batch's span says ``plain``; one routed to the card (here a
    stand-in for the kernel) says ``kernel``."""
    b, keys = _batch("i32")
    if route == "kernel":
        plain = th.hash_columns
        monkeypatch.setattr(hk, "_on_card", lambda name, *ts: True)
        monkeypatch.setattr(th, "_hash_keys", lambda cols: plain(cols))
    sink = Collector()
    trace.install(sink)
    try:
        th.hash_batch_keys(b, keys)
    finally:
        trace.install(None)
    assert [(s["name"], s["attrs"]) for s in sink] == [
        ("hash", {"rows": b.capacity, "keys": 1, "route": route})]


def test_wide_calls_launch_once_per_32_columns_seeded(monkeypatch):
    """40 key columns: two launches of 32 and 8 columns, the second
    seeded with the first's lanes.  A stand-in library that combines each
    launch's columns as the kernel does (into the lanes when seeded) gives
    hash_columns' bits."""
    b, keys = _batch("wide40")
    cols = [b.columns[k] for k in keys]
    by_ptr = {(c.data if isinstance(c, StringColumn) else c).data_ptr(): c
              for c in cols}
    calls = []

    def lanes(ptr, n):
        return torch.from_numpy(np.ctypeslib.as_array(
            (ctypes.c_longlong * n).from_address(ptr)))

    def launch(desc, ncols, n, weights, seeded, hi, lo, stream):
        d = np.ctypeslib.as_array(
            (ctypes.c_longlong * (7 * ncols)).from_address(desc))
        chunk = [by_ptr[p] for p in d.reshape(ncols, 7)[:, 0]]
        calls.append((ncols, seeded, weights is not None))
        h = (lanes(hi, n).clone(), lanes(lo, n).clone()) if seeded else \
            th.hash_column(chunk.pop(0))
        for c in chunk:
            h = th._combine(h, th.hash_column(c))
        lanes(hi, n)[:], lanes(lo, n)[:] = h
        return 0

    monkeypatch.setattr(_build, "library", lambda name: types.SimpleNamespace(
        dryad_hash_keys=launch))
    monkeypatch.setattr(th, "_device_weights", lambda dev: torch.zeros(1))
    monkeypatch.setattr(hk, "_stream", lambda t: 0)
    hk.reset_launches()
    hi, lo = th._hash_keys(cols)
    assert calls == [(32, 0, True), (8, 1, True)]
    assert hk.launches["hash_keys"] == 2
    want = th.hash_columns(cols)
    assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])


def test_descriptors_name_pointer_kind_width_and_strides():
    n = 10
    base = torch.arange(4 * n, dtype=torch.int64).view(n, 4)
    d, t = th._descriptor(base[:, 1:])                # [n, 3] view
    assert d == (base.data_ptr() + 8, 0, 32, 8, 0, 5, 3)
    assert t.shape == (n, 3)
    d, _ = th._descriptor(base[:, 2])                   # a strided column
    assert d == (base.data_ptr() + 16, 0, 32, 0, 0, 5, 1)
    d, _ = th._descriptor(torch.zeros(n, dtype=torch.float16)[::2])
    assert d[2:] == (4, 0, 0, 7, 1)
    d, _ = th._descriptor(torch.zeros((n, 0), dtype=torch.int32))
    assert d[5:] == (4, 0)
    strs = StringColumn(torch.zeros((n, 24), dtype=torch.uint8),
                        torch.zeros(2 * n, dtype=torch.int32)[::2])
    d, t = th._descriptor(strs)
    assert d == (strs.data.data_ptr(), strs.lengths.data_ptr(), 24, 1, 2,
                 11, 24) and t is strs.data
    # bytes that are not contiguous along the row are copied first
    wide = StringColumn(torch.zeros((24, n), dtype=torch.uint8).t(),
                        torch.zeros(n, dtype=torch.int32))
    d, t = th._descriptor(wide)
    assert t.is_contiguous() and d[0] == t.data_ptr() and d[2] == 24


@pytest.mark.parametrize("col,err", [
    (torch.zeros((4, 2, 2), dtype=torch.int32), ValueError),
    (torch.zeros(4, dtype=torch.complex64), TypeError),
    (StringColumn(torch.zeros((4, 513), dtype=torch.uint8),
                  torch.zeros(4, dtype=torch.int32)), ValueError),
    (StringColumn(torch.zeros((4, 8), dtype=torch.uint8),
                  torch.zeros(4, dtype=torch.int64)), TypeError),
    (StringColumn(torch.zeros((4, 8), dtype=torch.uint8),
                  torch.zeros(3, dtype=torch.int32)), ValueError)])
def test_descriptors_refuse_what_the_kernel_does_not_take(col, err):
    with pytest.raises(err):
        th._descriptor(col)


# ---------------------------------------------------------------------------
# the card


def _bf16_batch(device):
    v = torch.from_numpy(np.random.RandomState(3).randn(hc.N)
                         .astype(np.float32)).to(torch.bfloat16)
    v[:5] = torch.tensor([0.0, -0.0, 1e-39, float("inf"), float("nan")])
    return Batch({"k": v.to(device)},
                 torch.tensor(hc.N, dtype=torch.int32, device=device)), ["k"]


def _views(device):
    """Columns that are views: a strided int32, a column of a transposed
    int64 matrix, a [n, 2] slice, every third string row."""
    rng = np.random.RandomState(4)
    n = 3000
    i32 = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, 2 * n)
                           .astype(np.int32))[::2]
    i64 = torch.from_numpy(rng.randint(-2**62, 2**62, (3, n))
                           .astype(np.int64)).t()[:, 1]
    pair = torch.from_numpy(rng.randn(n, 4).astype(np.float32))[:, 1:3]
    s = tcol.string_column_from_list(hc._strings(rng, 3 * n), 3 * n, 16,
                                     "cpu")
    strs = StringColumn(s.data[::3], s.lengths[::3])
    cols = {"a": i32, "b": i64, "c": pair, "s": strs}
    b = Batch(cols, torch.tensor(n, dtype=torch.int32))
    return _to(b, device), list(cols)


def _held(batch, keys):
    """(the card's lanes, the plain version's on the CPU) of one batch."""
    hi, lo = th.hash_batch_keys(batch, keys)
    torch.cuda.synchronize()
    want = th.hash_columns([_to(batch, "cpu").columns[k] for k in keys])
    return (hi.cpu(), lo.cpu()), want


@pytest.mark.card
@pytest.mark.parametrize("kind", list(hc.CASES))
def test_card_lanes_equal_plain_and_jax(card, kind):
    b, keys = _batch(kind)
    (hi, lo), (phi, plo) = _held(_to(b, card), keys)
    assert torch.equal(hi, phi) and torch.equal(lo, plo)
    if kind not in hc.PLAIN_ONLY:
        assert hc.digest(hi.numpy(), lo.numpy()) == hc.JAX_DIGESTS[kind]


@pytest.mark.card
@pytest.mark.parametrize("make", [_bf16_batch, _views])
def test_card_lanes_equal_plain_for_bf16_and_views(card, make):
    (hi, lo), (phi, plo) = _held(*make(card))
    assert torch.equal(hi, phi) and torch.equal(lo, plo)


@pytest.mark.card
def test_card_three_int32_keys_at_2_pow_25_rows(card):
    """Q3's group-by key shape (three int32 keys) at 2**25 rows."""
    rng = np.random.RandomState(25)
    n = 1 << 25
    cols = {k: torch.from_numpy(rng.randint(-2**31, 2**31 - 1, n)
                                .astype(np.int32)) for k in "abc"}
    cpu = Batch(cols, torch.tensor(n, dtype=torch.int32))
    (hi, lo), (phi, plo) = _held(_to(cpu, card), list(cols))
    assert torch.equal(hi, phi) and torch.equal(lo, plo)


@pytest.mark.card
def test_card_launches_once_a_call_and_spans_say_kernel(card):
    hk.reset_launches()
    sink = Collector()
    trace.install(sink)
    try:
        for kind in ("i32", "multi", "i64x3", "str512", "zero", "i32"):
            b, keys = _batch(kind, "cuda")
            th.hash_batch_keys(b, keys)
    finally:
        trace.install(None)
    torch.cuda.synchronize()
    assert hk.launches["hash_keys"] == 5            # the zero-row call: 0
    assert sum(hk.launches.values()) == 5
    assert [s["attrs"]["route"] for s in sink] == ["kernel"] * 6


@pytest.mark.card
def test_card_wide_keys_launch_once_per_32_columns(card):
    """More key columns than a launch takes (40: the widest TPC-DS fact
    tables have 34): one launch per 32 columns, the plain version's
    bits."""
    b, keys = _batch("wide40")
    hk.reset_launches()
    (hi, lo), (phi, plo) = _held(_to(b, card), keys)
    assert hk.launches["hash_keys"] == 2
    assert torch.equal(hi, phi) and torch.equal(lo, plo)
