#!/usr/bin/env python3
"""Drive the PyTorch port (dryad_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--lines N] [--rows N] [--out DIR]

Phases, each failing the run (non-zero exit, no result line) on error:

  0. the card's name and power limit (``nvidia-smi``); no CUDA -> exit 2;
  1. build: all five Hopper kernels compile from
     ``dryad_tpu_torch/ops/csrc`` (one nvcc per source, all at once);
  2. kernels: each kernel against its plain PyTorch version on the card,
     at edge shapes (n = 0 and 1, ragged tiles, sentinels and negative
     ids, D = 1/8/16, C < 8, counts 0 and >= C, out_rows below the total).
     Integers must match exactly; the f32 scan within 1e-5 x max|prefix|
     of a float64 cumsum (the additions run in another order); the
     compensated scan, kernel and plain alike, within 2**-40 x
     sum_{i<=j} |x_i| of the exact prefix on a dyadic grid, and group sums
     differenced from both lanes within the group bound after a prefix of
     1e9 (where a plain f32 prefix errs by ~64 and must fail it).  The
     look-back scans also: five calls on one input bit-identical (i32,
     u32, f32, both prefix_sum2 lanes, n = 1,250,000 and 20,000,001); 50
     calls of each queued with no sync over sizes 1 to 1,250,000, each
     then held; tile counts just above the blocks the card holds at once;
     an input not 16-byte aligned;
  3. WordCount through ``Context(device="cuda", nparts=8)`` on two
     corpora of N lines (default 1,000,000: the JAX bench's 12-word
     vocabulary corpus, and 50,000 synthetic words sampled Zipf(1.1)),
     held exactly against a ``collections.Counter`` oracle; every launch
     counter of the WordCount path must have risen during each run;
  4. GroupByReduce through the same entry points at the JAX bench's size
     for BASELINE config 3 (default 2,000,000 rows, seed 0): the app's
     query on 10,000 keys, the same aggregates as one user Decomposable,
     and count/sum/mean on 500 keys (the small-key lowering), each held
     against a numpy oracle (keys, counts, min, max exact; f32 sums and
     means within the group bound); every launch counter must rise in the
     app's run, prefix_sum2 once per partition, and the exchange's four
     in every run;
  3-4. after each of those five main-path runs, every kernel call it made
     is made again through the kernel and through its plain version on
     the very tensors the run passed (integers exactly, prefix_sum2
     within twice its bound);
  5. timing: each kernel, its plain version and one library call at the
     largest call of one main-path run (``TIMED_ON``; CUDA events), the
     bound the card's memory rate sets for the same bytes, and a
     torch.profiler breakdown of one warm run of each timed path (a
     kernel launched there with no profiled device time fails the run).
     Per kernel at its timed shape also: the device time per call and the
     device events (kernels, memsets) per call from a profiler window
     around 20 calls, and the host's enqueue time per call (200 calls, no
     sync).  A kernel row's ``launches`` sums its launches over the five
     main-path runs; ``runs`` gives each run's own count and
     |kernel - plain|.

Output: one JSON line per corpus, per GroupByReduce variant and per
kernel, then the card line, then the ``{"kernels": [...]}`` line, then the
result line ``{"ok": true, "device": {...}}`` last.  Long logs (nvcc
-Xptxas -v, the profiles) go under ``--out`` (default chiprun_out/).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak bandwidth
PEAK_OPS_PER_S = 67e12       # H100 SXM non-tensor float32; int32 adds are
                             # counted at the same rate
NPARTS = 8                   # logical partitions on the one card
F32_TOL = 1e-5               # x max|prefix|, as tests/test_pallas_kernels
DD_TOL = 2.0**-40            # x sum_{i<=j} |x_i|: prefix_sum2's bound
EPS = 2.0**-24

TPU_KERNEL = {   # the Pallas function each kernel replaces
    "hist_buckets": "dryad_tpu/ops/pallas_kernels.py:137",
    "prefix_sum": "dryad_tpu/ops/pallas_kernels.py:270",
    "prefix_sum2": "dryad_tpu/ops/pallas_kernels.py:300",
    "slot_expand": "dryad_tpu/ops/pallas_kernels.py:384",
    "slot_compact": "dryad_tpu/ops/pallas_kernels.py:445",
}
# the main-path run whose largest call each kernel is timed on, and whose
# profile gives its device time per launch
TIMED_ON = {"hist_buckets": "zipf50k", "prefix_sum": "zipf50k",
            "prefix_sum2": "app10k", "slot_expand": "zipf50k",
            "slot_compact": "zipf50k"}
EXCHANGE = ("hist_buckets", "prefix_sum", "slot_expand", "slot_compact")
DEVICE_NAMES = {  # substrings of the compiled kernels' names
    "hist_buckets": ("hist_shared", "hist_global"),
    "prefix_sum": ("scan_lookback",),
    "prefix_sum2": ("scan2_lookback",),
    "slot_expand": ("slot_expand_k",),
    "slot_compact": ("slot_compact_k",),
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def import_port():
    """The port from this checkout, never from anywhere else."""
    sys.path.insert(0, HERE)
    import dryad_tpu_torch
    pkg = os.path.dirname(os.path.abspath(dryad_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise RuntimeError(f"dryad_tpu_torch imported from {pkg}, not from "
                           f"this checkout {HERE}")
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "dryad_tpu" or m.startswith("dryad_tpu.")]
    if bad:
        raise RuntimeError(f"the port pulled in {bad}")
    return dryad_tpu_torch


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def check_kernels(hk, dev) -> None:
    """Each kernel against its plain version at edge shapes."""
    import torch
    rng = np.random.RandomState(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def same(name, got, want, what):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{name} {what}: kernel != plain")

    for n, nb in [(0, 4), (1, 5), (4097, 8), (1_000_003, 8), (70_000, 513),
                  (200_000, 20_000)]:
        bid = rng.randint(0, nb, n).astype(np.int32)
        bid[::7] = nb
        bid[::11] = -3
        x = t(bid)
        same("hist_buckets", hk.hist_buckets(x, nb),
             hk.hist_buckets_plain(x, nb), f"n={n} nb={nb}")

    for n in [0, 1, 4095, 4096, 4097, 1_250_000, 20_000_001]:
        xi = t(rng.randint(-2**31, 2**31 - 1, n).astype(np.int32))
        same("prefix_sum", hk.prefix_sum(xi), hk.prefix_sum_plain(xi),
             f"i32 n={n}")
        yu = hk.prefix_sum(xi.view(torch.uint32)).view(torch.int32)
        same("prefix_sum", yu, hk.prefix_sum_plain(xi), f"u32 n={n}")
        xf = rng.rand(n).astype(np.float32)
        yf = hk.prefix_sum(t(xf)).cpu().numpy().astype(np.float64)
        ref = np.cumsum(xf.astype(np.float64))
        if n:
            e = float(np.abs(yf - ref).max())
            if e > F32_TOL * float(np.abs(ref).max()):
                raise AssertionError(f"prefix_sum f32 n={n}: err {e}")

    for n in [0, 1, 4095, 4096, 4097, 250_000, 20_000_001]:
        # dyadic grid k/256: the float64 cumsum is exact
        xd = t((rng.randint(-2**13, 2**15, n) / 256).astype(np.float32))
        ref = torch.cumsum(xd.double(), 0)
        bound = DD_TOL * torch.cumsum(xd.double().abs(), 0)
        for what, (hi, lo) in (("kernel", hk.prefix_sum2(xd)),
                               ("plain", hk.prefix_sum2_plain(xd))):
            torch.cuda.synchronize()
            err = (hi.double() + lo.double() - ref).abs()
            if hi.shape != xd.shape or not bool((err <= bound).all()):
                raise AssertionError(f"prefix_sum2 {what} n={n}: outside "
                                     f"the 2**-40 bound")
    check_cancellation(hk, t)
    check_lookback(hk, t, rng)

    for cap, W, D, C in [(64, 3, 1, 5), (500, 8, 8, 3), (65_536, 8, 8, 16_384),
                         (10_000, 7, 16, 700), (300, 2, 8, 300)]:
        words = t(rng.randint(-2**31, 2**31 - 1, (cap, W)).astype(np.int32))
        cnt = rng.randint(0, 2 * cap // D + 2, D)
        offs = np.cumsum(cnt) - cnt
        offs[-1] = cap - 1          # a run that reads into the zero pad
        offs = t(offs.astype(np.int32))
        same("slot_expand", hk.slot_expand(words, offs, C),
             hk.slot_expand_plain(words, offs, C), f"D={D} C={C}")

    for D, C, W, out_rows in [(1, 10, 3, 12), (8, 16, 4, 40), (8, 16, 4, 200),
                              (16, 5, 2, 90), (8, 16_384, 8, 1_250_000),
                              (8, 16_384, 8, 70_000)]:
        words = t(rng.randint(-2**31, 2**31 - 1, (D * C, W)).astype(np.int32))
        counts = rng.randint(0, C + 1, D).astype(np.int32)
        counts[0] = 0
        counts[-1] = C + 9
        counts = t(counts)
        same("slot_compact", hk.slot_compact(words, counts, C, out_rows),
             hk.slot_compact_plain(words, counts, C, out_rows),
             f"D={D} C={C} out_rows={out_rows}")


def check_lookback(hk, t, rng) -> None:
    """What a single-pass look-back scan can get wrong.  Determinism: five
    calls on one input give the same bits (i32, u32, f32, both lanes of
    prefix_sum2).  Back-to-back: 50 calls of each scan over sizes from 1
    to 1,250,000 queued with no sync, then each held against the exact
    result (scratch state leaking from one call into the next), and every
    kept scratch's head and flags zero again at the end.  Tile
    counts just above the blocks the card holds at once: SMs x k tiles
    plus one element, for every k up to the 512-thread blocks an SM can
    hold; and an input misaligned for 16-byte loads."""
    import torch

    def bits(a):
        return a.view(torch.int32)

    def dd_ok(x, pair):
        ref = torch.cumsum(x.double(), 0)
        bound = DD_TOL * torch.cumsum(x.double().abs(), 0)
        return bool(((_dd_value(pair) - ref).abs() <= bound).all())

    for n in (1_250_000, 20_000_001):
        xi = t(rng.randint(-2**31, 2**31 - 1, n).astype(np.int32))
        xf = t(rng.rand(n).astype(np.float32))
        xd = t(rng.randn(n).astype(np.float32))
        cases = {
            "i32": lambda: [hk.prefix_sum(xi)],
            "u32": lambda: [hk.prefix_sum(xi.view(torch.uint32))],
            "f32": lambda: [hk.prefix_sum(xf)],
            "prefix_sum2": lambda: list(hk.prefix_sum2(xd)),
        }
        for what, fn in cases.items():
            outs = [fn() for _ in range(5)]
            torch.cuda.synchronize()
            for o in outs[1:]:
                if not all(torch.equal(bits(a), bits(b))
                           for a, b in zip(o, outs[0])):
                    raise AssertionError(f"{what} n={n}: five calls on one "
                                         f"input differ in their bits")

    sizes = (1, 4096, 4097, 250_000, 1_250_000)
    ins = {n: (t(rng.randint(-2**31, 2**31 - 1, n).astype(np.int32)),
               t((rng.randint(-2**13, 2**15, n) / 256).astype(np.float32)))
           for n in sizes}
    torch.cuda.synchronize()
    queued = [(n, hk.prefix_sum(ins[n][0]), hk.prefix_sum2(ins[n][1]))
              for n in sizes * 10]
    torch.cuda.synchronize()
    for i, (n, y, pair) in enumerate(queued):
        if not torch.equal(y, hk.prefix_sum_plain(ins[n][0])):
            raise AssertionError(f"prefix_sum queued call {i} n={n}: "
                                 f"kernel != plain")
        if not dd_ok(ins[n][1], pair):
            raise AssertionError(f"prefix_sum2 queued call {i} n={n}: "
                                 f"outside the 2**-40 bound")

    props = torch.cuda.get_device_properties(0)
    per_sm = getattr(props, "max_threads_per_multi_processor", 2048) // 512
    # (n, off): the last scans a view one element in, so the input is not
    # 16-byte aligned and the tiles load element by element
    cases = [(props.multi_processor_count * k * hk._SCAN_TILE + 1, 0)
             for k in range(1, per_sm + 1)] + [(1_250_000, 1)]
    for n, off in cases:
        xi = t(rng.randint(-2**31, 2**31 - 1, n + off).astype(np.int32))[off:]
        xd = t((rng.randint(-2**13, 2**15, n + off) / 256).astype(
            np.float32))[off:]
        if not torch.equal(hk.prefix_sum(xi), hk.prefix_sum_plain(xi)):
            raise AssertionError(f"prefix_sum n={n} off={off}: kernel != "
                                 f"plain")
        f = hk.prefix_sum(xd).double()
        ref = torch.cumsum(xd.double(), 0)
        if float((f - ref).abs().max()) > F32_TOL * float(ref.abs().max()):
            raise AssertionError(f"prefix_sum f32 n={n} off={off}: outside "
                                 f"the f32 tolerance")
        if not dd_ok(xd, hk.prefix_sum2(xd)):
            raise AssertionError(f"prefix_sum2 n={n} off={off}: outside "
                                 f"the 2**-40 bound")

    torch.cuda.synchronize()
    head = hk._SCAN_HEAD_WORDS
    for (name, *_), buf in hk._scan_scratch_bufs.items():
        if buf[:head].any() or buf[head::hk._SCAN_SCRATCH_WORDS[name]].any():
            raise AssertionError(f"{name}: a kept scratch is not cleared "
                                 f"after its kernels ran")


def hold(hk, name, args, what) -> float:
    """The wrapper (the kernel) against the plain version on the same
    inputs: integers exactly, the f32 scan within F32_TOL x max|prefix|,
    the compensated scan within twice its bound (each lies within the
    bound of the exact prefix).  Returns the largest |kernel - plain|."""
    import torch
    got = getattr(hk, name)(*args)
    want = getattr(hk, name + "_plain")(*args)
    torch.cuda.synchronize()
    if name == "prefix_sum2":
        (x,) = args
        bound = DD_TOL * torch.cumsum(x.double().abs(), 0)
        err = (_dd_value(got) - _dd_value(want)).abs()
        if got[0].shape != x.shape or not bool((err <= 2 * bound).all()):
            raise AssertionError(f"prefix_sum2 {what}: kernel and plain "
                                 f"differ by more than twice the bound")
        return float(err.max()) if x.numel() else 0.0
    if got.shape != want.shape:
        raise AssertionError(f"{name} {what}: kernel and plain shapes "
                             f"differ")
    if got.dtype == torch.float32:
        err = (got.double() - want.double()).abs()
        if got.numel() and float(err.max()) > F32_TOL * float(
                want.double().abs().max()):
            raise AssertionError(f"{name} {what}: kernel != plain beyond "
                                 f"the f32 tolerance")
        return float(err.max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"{name} {what}: kernel != plain")
    return 0.0


def hold_run(hk, run, captured) -> dict:
    """Every kernel call a main-path run made, made again through the
    kernel and through its plain version on the very tensors that run
    passed it.  Returns {kernel: largest |kernel - plain|}."""
    errs = {}
    for name, calls in captured.items():
        for i, (_size, args) in enumerate(calls):
            e = hold(hk, name, args, f"{run} call {i}")
            errs[name] = max(errs.get(name, 0.0), e)
    return errs


def check_cancellation(hk, t) -> None:
    """1,000 values of 1e6 (the prefix climbs to 1e9), then 10,000 groups
    of 16 values in [0, 1/8): each group's sum, differenced from both
    lanes of the compensated prefix, must hold the group bound
    16 eps sum_group|v| + 16 eps^2 P (about 6e-5 here); the same
    differencing over the plain f32 prefix_sum kernel must not."""
    import torch
    rng = np.random.RandomState(3)
    G, g = 10_000, 16
    small = (rng.rand(G * g) / 8).astype(np.float32)
    x = t(np.concatenate([np.full(1000, 1e6, np.float32), small]))
    b = t(1000 + g * np.arange(1, G + 1) - 1)
    a = b - g
    grp = t(small).double().reshape(G, g)
    bound = (16 * EPS * grp.abs().sum(1)
             + 16 * EPS**2 * x.double().abs().sum())
    want = grp.sum(1)
    for what, (hi, lo) in (("kernel", hk.prefix_sum2(x)),
                           ("plain", hk.prefix_sum2_plain(x))):
        got = (hi[b] - hi[a]) + (lo[b] - lo[a])
        if not bool(((got.double() - want).abs() <= bound).all()):
            raise AssertionError(f"prefix_sum2 {what}: group sums outside "
                                 f"the bound after a 1e9 prefix")
    f = hk.prefix_sum(x)
    if bool(((f[b] - f[a]).double() - want).abs().le(bound).all()):
        raise AssertionError("cancellation check has no teeth: the plain "
                             "f32 prefix met the group bound")


# ---------------------------------------------------------------------------
# phase 3: WordCount


def bench_corpus(n: int):
    """The JAX bench's WordCount corpus (bench.py): 8 words a line from a
    12-word vocabulary, numpy seed 0."""
    rng = np.random.RandomState(0)
    vocab = np.array(["alpha", "beta", "gamma", "delta", "epsilon", "zeta",
                      "eta", "theta", "iota", "kappa", "lam", "mu"])
    idx = rng.randint(0, len(vocab), (n, 8))
    return [" ".join(vocab[i]) for i in idx]


def zipf_corpus(n: int, n_words: int = 50_000):
    """Same shape, 50,000 synthetic lowercase words (lengths 3-10, numpy
    seed 1) sampled Zipf(s=1.1): tens of thousands of groups per
    partition, so the exchange moves real rows."""
    rng = np.random.RandomState(1)
    lens = rng.randint(3, 11, n_words)
    letters = rng.randint(0, 26, (n_words, 10)).astype(np.uint8) + ord("a")
    words = np.array([letters[i, :lens[i]].tobytes().decode()
                      for i in range(n_words)])
    p = 1.0 / np.arange(1, n_words + 1) ** 1.1
    idx = rng.choice(n_words, (n, 8), p=p / p.sum())
    return [" ".join(words[i]) for i in idx]


def oracle(lines) -> dict:
    c = collections.Counter()
    for line in lines:
        c.update(line.encode().split())
    return c


def run_wordcount(port, hk, wc, lines):
    """One main-path run through the user's entry points (what
    ``wordcount()`` does, timed in two parts: host packing + copy to the
    card, then the query and collect).  Counters zeroed just before, read
    just after.  Returns (table, launches, load_s, query_s)."""
    import torch
    ctx = port.Context(device="cuda", nparts=NPARTS)
    per_part = -(-len(lines) // NPARTS)
    hk.reset_launches()
    t0 = time.perf_counter()
    ds = ctx.from_columns({"line": lines}, str_max_len=96)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = wc.wordcount_query(ds, tokens_per_partition=per_part * 10).collect()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return out, dict(hk.launches), t1 - t0, t2 - t1


# ---------------------------------------------------------------------------
# phase 4: GroupByReduce


def gbr_variants(port, gbr):
    """name -> (keys, query, output columns): the app's query; the same
    aggregates as ONE user Decomposable whose state is (count, sum, min,
    max); count/sum/mean on 500 keys (span <= 512: the small-key
    lowering in the partial stage)."""
    import torch

    def seed(c):
        v = c["v"]
        return (torch.ones(v.shape[0], dtype=torch.int32, device=v.device),
                v, v, v)

    stats = port.Decomposable(
        seed,
        lambda a, b: (a[0] + b[0], a[1] + b[1], torch.minimum(a[2], b[2]),
                      torch.maximum(a[3], b[3])),
        lambda s: {"n": s[0], "s": s[1], "m": s[1] / s[0], "lo": s[2],
                   "hi": s[3]})
    full = ("n", "s", "m", "lo", "hi")
    return {
        "app10k": (10_000, gbr.groupbyreduce_query, full),
        "decomposable10k": (10_000, lambda ds: ds.group_by(
            ["k"], {"d": stats}), full),
        "smallkey500": (500, lambda ds: ds.group_by(["k"], {
            "n": ("count", None), "s": ("sum", "v"), "m": ("mean", "v")}),
            ("n", "s", "m")),
    }


def run_gbr(port, hk, data, query):
    """One main-path GroupByReduce run through the user's entry points,
    timed as load (from_columns: host packing + copy to the card) and
    query (plan, stages, collect).  Counters zeroed just before, read
    just after.  Returns (table, launches, load_s, query_s)."""
    import torch
    ctx = port.Context(device="cuda", nparts=NPARTS)
    hk.reset_launches()
    t0 = time.perf_counter()
    ds = ctx.from_columns(data)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = query(ds).collect()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return out, dict(hk.launches), t1 - t0, t2 - t1


def check_gbr(name, out, data, cols) -> None:
    """Against a numpy oracle: keys, counts, min, max exact; f32 sums
    within 16 eps sum_group|v| + 16 eps^2 P (P = sum|v| over all rows, at
    least any partition's), means within that / count."""
    k, v = data["k"], data["v"]
    v64 = v.astype(np.float64)
    m = int(k.max()) + 1
    cnt = np.bincount(k, minlength=m)
    keys = np.flatnonzero(cnt)
    o = np.argsort(out["k"])
    if not np.array_equal(out["k"][o], keys):
        raise AssertionError(f"{name}: the groups differ from the oracle")
    if not np.array_equal(out["n"][o], cnt[keys]):
        raise AssertionError(f"{name}: counts differ from the oracle")
    s = np.bincount(k, weights=v64, minlength=m)[keys]
    bound = (16 * EPS * np.bincount(k, weights=np.abs(v64), minlength=m)
             [keys] + 16 * EPS**2 * float(np.abs(v64).sum()))
    if not (np.abs(out["s"][o] - s) <= bound).all():
        raise AssertionError(f"{name}: f32 sums outside the bound")
    if not (np.abs(out["m"][o] - s / cnt[keys]) <= bound / cnt[keys]).all():
        raise AssertionError(f"{name}: means outside the bound")
    if "lo" in cols:
        lo = np.full(m, np.inf, np.float32)
        hi = np.full(m, -np.inf, np.float32)
        np.minimum.at(lo, k, v)
        np.maximum.at(hi, k, v)
        if not (np.array_equal(out["lo"][o], lo[keys])
                and np.array_equal(out["hi"][o], hi[keys])):
            raise AssertionError(f"{name}: min/max differ from the oracle")


# ---------------------------------------------------------------------------
# phase 5: timing


def cuda_ms(fn, reps: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def work(name: str, args) -> tuple:
    """(bytes the function must move, operations it does) for these
    inputs: each input byte read once, each output byte written once."""
    if name == "hist_buckets":
        bid, nb = args
        return 4 * bid.numel() + 4 * nb, bid.numel()
    if name == "prefix_sum":
        (x,) = args
        return 8 * x.numel(), x.numel()
    if name == "prefix_sum2":
        # f32 in, (hi, lo) out; one TwoSum combine (10 f32 adds) an element
        (x,) = args
        return 12 * x.numel(), 10 * x.numel()
    if name == "slot_expand":
        # rows read: the union of the runs [start, min(start + C, cap)),
        # which overlap (C exceeds the fair share); rows written: D*C
        words, offs, C = args
        cap, W = words.shape
        real = reach = 0
        for s in sorted(offs.long().clamp(0, cap).tolist()):
            s, e = max(s, reach), min(s + C, cap)
            real += max(e - s, 0)
            reach = max(reach, e)
        return 4 * W * (real + offs.numel() * C) + 4 * offs.numel(), 0
    words, counts, C, out_rows = args
    W = words.shape[1]
    valid = min(int(counts.long().clamp(0, C).sum()), out_rows)
    return 4 * W * (valid + out_rows) + 4 * counts.numel(), 0


def library_call(name: str, args):
    """PyTorch's library ops computing the same function, output for
    output (a yardstick only; the port never calls it), or None.  The
    slot kernels have no one-call counterpart: theirs is the gather index
    built from the offsets/counts, then one ``index_select`` (into a
    zeroed output for ``slot_compact``), all inside the timed call.
    ``prefix_sum2``'s is the JAX fallback's x64 recipe: a float64 cumsum
    split into its f32 head and the f32 rounding of the rest."""
    import torch
    if name == "hist_buckets":
        bid, nb = args
        return lambda: torch.bincount(bid, minlength=nb + 1)[:nb]
    if name == "prefix_sum":
        (x,) = args
        return lambda: torch.cumsum(x, 0, dtype=x.dtype)
    if name == "prefix_sum2":
        (x,) = args

        def dd_cumsum():
            c = torch.cumsum(x.double(), 0)
            hi = c.float()
            return hi, (c - hi.double()).float()
        return dd_cumsum
    if name == "slot_expand":
        words, offs, C = args
        cap, W = words.shape

        def expand():
            xp = torch.cat([words, words.new_zeros((C, W))])
            src = (offs.long().clamp(0, cap)[:, None]
                   + torch.arange(C, device=words.device)[None, :])
            return xp.index_select(0, src.reshape(-1))
        return expand
    words, counts, C, out_rows = args

    def compact():
        cnt = counts.long().clamp(0, C)
        idx = torch.arange(words.shape[0], device=words.device)
        keep = (idx % C) < cnt[idx // C]
        src = torch.nonzero(keep).squeeze(1)[:out_rows]
        out = words.new_zeros((out_rows, words.shape[1]))
        torch.index_select(words, 0, src, out=out[:src.numel()])
        return out
    return compact


def profile_calls(name: str, fn, calls: int = 20) -> dict:
    """torch.profiler over ``calls`` wrapper calls at the timed shape and
    nothing else: the row's kernel time per call, and the device events
    (kernels and memsets) per call, in all and by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    # one warm-up step first: a window's first device event goes
    # unrecorded (20 calls showed as 19 events on the H100)
    avgs = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: avgs.append(p.key_averages())
                 ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        prof.step()
    ours = events = 0
    by_name = {}
    for ev in avgs[0]:
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.key.startswith("ProfilerStep")):
            continue
        events += ev.count
        by_name[ev.key[:80]] = ev.count / calls
        if any(s in ev.key for s in DEVICE_NAMES[name]):
            ours += ev.self_device_time_total
    if not ours:
        raise AssertionError(f"{name}: no profiled device time under "
                             f"{DEVICE_NAMES[name]} at the timed shape")
    return {"device_us_at_timed_shape": ours / calls,
            "device_kernels_per_call": events / calls,
            "device_events_per_call": by_name}


def host_enqueue_us(fn, calls: int = 200) -> float:
    """Host time of one wrapper call: ``calls`` calls with no sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _dd_value(pair):
    """hi + lo of a (hi, lo) pair, in float64."""
    return pair[0].double() + pair[1].double()


def time_kernels(hk, runs, timed, card) -> list:
    """One row per kernel.  ``runs``: every main-path run's label ->
    (launches, {kernel: largest |kernel - plain| over its calls}); the
    row's ``launches`` is their sum, ``runs`` each one's own.  ``timed``:
    the label ``TIMED_ON`` names -> (captured calls, profile); the kernel,
    its plain version and the library call are timed on that run's
    largest call, and its profile gives the device time per launch."""
    import torch
    rows = []
    for name in TPU_KERNEL:
        label = TIMED_ON[name]
        captured, prof = timed[label]
        _size, args = max(captured[name], key=lambda c: c[0])
        wrapper = getattr(hk, name)
        plain = getattr(hk, name + "_plain")
        got = wrapper(*args)
        lib = library_call(name, args)
        torch.cuda.synchronize()
        if name == "prefix_sum2":
            (x,) = args
            bound = DD_TOL * torch.cumsum(x.double().abs(), 0)
            lerr = (_dd_value(lib()) - _dd_value(got)).abs()
            if not bool((lerr <= 2 * bound).all()):
                raise AssertionError("prefix_sum2: kernel and library "
                                     "disagree beyond the bound")
        elif lib is not None:
            ref = lib()
            if ref.shape != got.shape or not torch.equal(
                    ref.to(got.dtype), got):
                raise AssertionError(f"{name}: the library yardstick does "
                                     f"not compute the same function")
        per_run = {r: {"launches": l[name], "max_abs_err": e[name]}
                   for r, (l, e) in runs.items() if l[name]}
        prof_launches = prof["launches"][name]
        prof_ms = (prof.get("port_kernels_ms") or {}).get(name, 0.0)
        if prof_launches and not prof_ms:
            raise AssertionError(
                f"{name}: {prof_launches} launches in the profiled {label} "
                f"run but no profiled device time: DEVICE_NAMES misses its "
                f"kernels")
        nbytes, ops = work(name, args)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": f"dryad_tpu_torch/ops/csrc/{name}.cu",
            "replaces": TPU_KERNEL[name],
            "launches": sum(r["launches"] for r in per_run.values()),
            "max_abs_err": max(r["max_abs_err"] for r in per_run.values()),
            "ms": cuda_ms(lambda: wrapper(*args)),
            "plain_ms": cuda_ms(lambda: plain(*args)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": cuda_ms(lib) if lib is not None else None,
            "runs": per_run,
            # device time alone, per launch, from the profiled warm run
            # of the timed path (ms above also holds the host's gaps)
            "profiled_device_ms_per_launch": (
                prof_ms / prof_launches if prof_launches else None),
            # the same at the timed shape alone, and the host's side
            **profile_calls(name, lambda: wrapper(*args)),
            "host_enqueue_us": host_enqueue_us(lambda: wrapper(*args)),
            "timed_on": label,
            "shape": [list(a.shape) if hasattr(a, "shape") else a
                      for a in args],
            "bytes": nbytes,
            "card": card,
        })
    return rows


def profile_run(run, label, out_dir) -> dict:
    """Device time by kernel over one warm run of a path (kernel-level
    events only: the operator-level rows repeat their kernels' time).
    ``run()`` returns (table, launches, load_s, query_s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _out, launches, load, query = run()
    wall = load + query
    avgs = prof.key_averages()
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
        f.write(avgs.table(sort_by="self_cuda_time_total", row_limit=60))
    dev_ms = collections.Counter()
    for ev in avgs:
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_ms[ev.key] += ev.self_device_time_total / 1e3
    if not dev_ms:
        return {"device_ms": None, "wall_s": wall, "load_s": load,
                "query_s": query, "launches": launches}
    ours = {k: sum(v for key, v in dev_ms.items()
                   if any(s in key for s in subs))
            for k, subs in DEVICE_NAMES.items()}
    total = sum(dev_ms.values())
    return {"wall_s": wall, "load_s": load, "query_s": query,
            "launches": launches, "device_ms": total,
            "device_busy_share": total / 1e3 / wall,
            "port_kernels_ms": ours,
            "rest_ms": total - sum(ours.values()),
            "top": [[k[:120], v] for k, v in dev_ms.most_common(12)]}


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lines", type=int, default=1_000_000)
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out"))
    a = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    os.makedirs(a.out, exist_ok=True)

    port = import_port()
    from dryad_tpu_torch.apps import groupbyreduce as gbr
    from dryad_tpu_torch.apps import wordcount as wc
    from dryad_tpu_torch.ops import _build
    from dryad_tpu_torch.ops import hopper_kernels as hk
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    with open(os.path.join(a.out, "nvcc_ptxas.log"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "kernels": sorted(logs), "card": card}), flush=True)

    check_kernels(hk, dev)
    print(json.dumps({"phase": "kernels", "ok": True, "card": card}),
          flush=True)

    # every main-path run: label -> (launches, {kernel: max |kernel -
    # plain|} over all its calls); the TIMED_ON runs keep their calls
    runs, timed_calls = {}, {}

    def held(label, launches, captured):
        runs[label] = (launches, hold_run(hk, label, captured))
        if label in TIMED_ON.values():
            timed_calls[label] = captured

    corpora = {"bench12": bench_corpus(a.lines),
               "zipf50k": zipf_corpus(a.lines)}
    for cname, lines in corpora.items():
        want = oracle(lines)
        hk.capture = {}
        out, launches, load, query = run_wordcount(port, hk, wc, lines)
        captured, hk.capture = hk.capture, None
        held(cname, launches, captured)
        got = dict(zip(out["line"], (int(v) for v in out["n"])))
        if got != want:
            diff = [(k, got.get(k), want.get(k)) for k in
                    set(got) | set(want) if got.get(k) != want.get(k)]
            raise AssertionError(f"{cname}: {len(diff)} words differ from "
                                 f"the oracle, e.g. {diff[:5]}")
        zero = [k for k in EXCHANGE if launches[k] == 0]
        if zero:
            raise AssertionError(f"{cname}: kernels never launched: {zero}")
        _, _, wload, wquery = run_wordcount(port, hk, wc, lines)
        warm = wload + wquery
        print(json.dumps({
            "corpus": cname, "lines": len(lines), "nparts": NPARTS,
            "words": len(want), "tokens": sum(want.values()),
            "launches": launches, "cold_wall_s": load + query,
            "warm_wall_s": warm, "warm_load_s": wload,
            "warm_query_s": wquery, "lines_per_s": len(lines) / warm,
            "card": card}), flush=True)

    variants = gbr_variants(port, gbr)
    for vname, (n_keys, query, cols) in variants.items():
        data = gbr.gen_pairs(a.rows, n_keys, seed=0)
        hk.capture = {}
        out, launches, load, qs = run_gbr(port, hk, data, query)
        captured, hk.capture = hk.capture, None
        check_gbr(vname, out, data, cols)
        held(vname, launches, captured)
        zero = [k for k in (TPU_KERNEL if vname == "app10k" else EXCHANGE)
                if launches[k] == 0]
        if zero:
            raise AssertionError(f"{vname}: kernels never launched: {zero}")
        if vname == "app10k":
            gbr_data = data
            if launches["prefix_sum2"] != NPARTS:
                raise AssertionError(
                    f"{vname}: prefix_sum2 launched "
                    f"{launches['prefix_sum2']} times, not once per "
                    f"partition in the partial stage")
        elif vname == "smallkey500" and launches["prefix_sum2"] != \
                2 * NPARTS:
            # the merge stage sums s and m__sum (2 per partition); a
            # partial stage off the small-key lowering would add more
            raise AssertionError(f"{vname}: prefix_sum2 launched "
                                 f"{launches['prefix_sum2']} times")
        _, _, wload, wquery = run_gbr(port, hk, data, query)
        warm = wload + wquery
        print(json.dumps({
            "groupbyreduce": vname, "rows": a.rows, "keys": n_keys,
            "groups": len(out["k"]), "nparts": NPARTS,
            "launches": launches, "cold_wall_s": load + qs,
            "warm_wall_s": warm, "warm_load_s": wload,
            "warm_query_s": wquery, "rows_per_s": a.rows / warm,
            "card": card}), flush=True)

    wc_prof = profile_run(
        lambda: run_wordcount(port, hk, wc, corpora["zipf50k"]),
        "wordcount_zipf50k", a.out)
    print(json.dumps({"profile": "wordcount zipf50k warm run", **wc_prof,
                      "card": card}), flush=True)
    gbr_prof = profile_run(
        lambda: run_gbr(port, hk, gbr_data, variants["app10k"][1]),
        "groupbyreduce_app10k", a.out)
    print(json.dumps({"profile": "groupbyreduce app10k warm run",
                      **gbr_prof, "card": card}), flush=True)
    print(json.dumps({"phase": "held", "ok": True, "runs": {
        r: {k: {"launches": l[k], "max_abs_err": e[k]} for k in e}
        for r, (l, e) in runs.items()}, "card": card}), flush=True)
    rows = time_kernels(hk, runs, {
        "zipf50k": (timed_calls["zipf50k"], wc_prof),
        "app10k": (timed_calls["app10k"], gbr_prof)}, card)
    for row in rows:
        print(json.dumps({"kernel": row}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
