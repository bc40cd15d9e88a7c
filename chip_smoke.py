#!/usr/bin/env python3
"""Drive the PyTorch port (dryad_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--lines N] [--rows N] [--records N] [--nodes N]
                          [--points N] [--lineitems N] [--orders N]
                          [--out DIR]

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
     an input not 16-byte aligned.  The exchange's batched kernels
     (``hist_buckets_batched``, ``slot_expand_batched``) at P = 1, 3, 8,
     every histogram route, sources misaligned for 16-byte loads (W = 7),
     C*W not a multiple of 4, run starts at and past cap and negative,
     the main paths' shapes, and 50 histograms of mixed sizes queued with
     no sync, each then held, the kept tickets zero afterwards.  The
     batched compaction (``slot_compact_batched``, ``check_compact``) at
     Dd = 1, 3, 8 and 8 at S = 4096; W = 1, 2, 7, 8, 46; counts negative,
     0, C and above C; out_rows 0, below the total and far above it;
     C = 1; sources misaligned; the main paths' shapes; 50 calls of mixed
     sizes queued with no sync; each output allocated over a freed block
     of 0x7F bytes, so an unwritten word shows;
  3. WordCount through ``Context(device="cuda", nparts=8)`` on two
     corpora of N lines (default 1,000,000: the JAX bench's 12-word
     vocabulary corpus, and 50,000 synthetic words sampled Zipf(1.1)),
     held exactly against a ``collections.Counter`` oracle; every launch
     counter of the WordCount path must have risen during each run, and
     hist_buckets, slot_expand and slot_compact exactly once per
     exchange;
  4. GroupByReduce through the same entry points at the JAX bench's size
     for BASELINE config 3 (default 2,000,000 rows, seed 0): the app's
     query on 10,000 keys, the same aggregates as one user Decomposable,
     and count/sum/mean on 500 keys (the small-key lowering), each held
     against a numpy oracle (keys, counts, min, max exact; f32 sums and
     means within the group bound); every launch counter must rise in the
     app's run, prefix_sum2 once per partition, and the exchange's four
     in every run (hist_buckets, slot_expand and slot_compact once per
     exchange);
  6. the sort paths through the same entry points: TeraSort on
     1,000,000 records (``terasort.gen_records(N, seed=0)``, the JAX
     bench's in-memory size, ``str_max_len=10``: a range exchange of
     5-word rows) held against Python's sorted (key, payload) pairs;
     ``order_by([("k", True), ("v", False)])`` on the GroupByReduce pairs
     (2,000,000 rows, 10,000 keys) against numpy's lexsort order;
     ``group_top_k(["k"], 3, "v")`` and ``group_median(["k"], "v")`` on
     them (one run, two queries) against numpy as multisets of (k, v)
     and exact lower medians; ``distinct(["k"])`` on them, each key's v
     that of its first row in input order.  Each run's exchange kernels
     must all launch, hist_buckets, slot_expand and slot_compact once
     per exchange attempt (a capacity retry is an attempt: the counts must equal the
     executor's own attempt log); its stages' retries and final capacity
     scales are printed;
  7. PageRank (``pagerank100k``) through the same entry points at the JAX
     bench's size for BASELINE config 4: ``gen_graph(100,000, 1,000,000,
     seed=0)`` (plus the 100,000 ring edges it adds), 10 iterations,
     damping 0.85: ``from_columns -> join -> cache -> do_while ->
     collect``.  The node set must be 0..n-1 exactly, every rank within
     rtol 2e-3 of ``pagerank_numpy`` (float64), the ranks' sum within
     1e-2 of 1; all five launch counters must rise, and hist_buckets,
     slot_expand and slot_compact launch once per exchanging leg and
     attempt (the executor's own log over every run of the job).  One cold and one
     warm run, each split into load (``from_columns``) and query; time
     per superstep; edges per second per iteration over the query wall
     and over the summed executor runs (the JAX bench's
     ``edges_per_sec_iter_chip_run`` form); attempts per stage.  Then
     NaN min/max: ``group_by(["k"], min/max of v)`` over 400 rows with
     NaNs, and an ``order_by`` of the max, on the card against a numpy
     oracle bit for bit (a NaN result is the JAX package's 0x7FC00000);
  8. k-means (``kmeans500k``) through the same entry points at the JAX
     bench's size for BASELINE config 5: ``gen_points(500,000, 8, 16,
     seed=0)``, k = 16, 5 iterations, init = the first 16 points:
     ``from_columns -> with_capacity -> do_while(cross_apply over the
     broadcast centroid table -> group_by mean -> with_capacity) ->
     collect``.  Every cid present and every centroid within rtol and
     atol 1e-3 of ``kmeans_numpy`` (float64); the exchange's four
     kernels must launch, hist_buckets and slot_expand once per hash
     exchange and slot_compact once per hash exchange plus ONCE per
     broadcast (the executor's own log).  One cold and one warm run,
     load and query, time per iteration, points per second per
     iteration, attempts per stage.  Then, each one main-path run held
     the same way: ``setops1m`` (``union``, ``intersect``, ``except_``
     and ``concat`` of two 1,000,000-row tables of (k, k % 97), keys
     drawn with replacement from overlapping ranges) against numpy's
     sets of rows (a multiset for concat); ``bcastjoin2m`` (the
     GroupByReduce pairs joined with a unique-keyed 10,000-row table,
     ``broadcast=True``: one slot_compact and no other exchange kernel)
     as a multiset against the same join planned with hash exchanges
     and against numpy; ``scalars2m`` (count, first, sum / min / max of
     the int32 key, sum / mean / min / max of the f32 value, any / all
     of derived flags, NaN min / max, ``aggregate`` with a user
     Decomposable) against numpy: the f32 sum and mean within the
     GroupByReduce bound, the rest exactly, NaN bits as numpy's;
  9. skewed joins, outer joins and the positional operators through the
     same entry points on TPC-H-shaped tables at SF1 cardinalities
     (``tpch_tables``: 6,000,000 lineitems, 90 % of them on order key 0
     as in the JAX bench's skewed join, 1,500,000 orders, 150,000
     customers; ``--lineitems N``), each run cold (held, launches against
     the executor's log, where a salted join attempt counts two hash
     exchanges and one broadcast), warm and profiled warm (busy share):
     ``skewjoin6m`` (lineitem joined with orders, flag == 0, revenue per
     customer, cached, collected whole and as its top 10): exactly
     numpy's, the join stage overflowing once unsalted and salted at
     attempt 2, its scale x 750,000 below N / 2 and every partition
     receiving fewer than 2N / P lineitems; ``skewjoin6m_relied`` (the
     same grouped by order key: the group-by trusts the join's placement)
     exactly numpy's and never salted, one retry at the measured scale;
     ``q13_outer`` (TPC-H Q13's shape: ``group_join`` of customers with
     their orders' count and f32 spend, the count of customers per count,
     the same counts by a right join, a full join of seg-0 customers with
     the prio-0 orders' aggregate): keys and counts exactly, f32 sums
     within the GroupByReduce bound, both sides' unmatched rows present;
     ``zip6m`` (two differently filtered lineitem sides zipped, a row
     index, skip, take_while; skip_while over a row index) exactly
     numpy's in global row order;
 10. the unnest-and-regroup path through the same entry points on
     ORDERS with their LINEITEMs nested (``nested_orders``: 1,500,000
     orders of 1 to 7 lines, about 6,000,000, TPC-H SF1; ``--orders N``),
     the orders hash-repartitioned (a 276 MB pure hash leg: the slot probe
     ships its first attempt's slot, below the structural one), unnested
     by ``flat_map``, claimed hash-placed by okey, net added by
     ``apply_per_partition``: ``unnest6m`` (each order's top two lines by
     net, ties by line, by ``group_apply`` under ``torch.func.vmap``, with
     no exchange: the claim) and ``unnest6m_shuffled`` (the same without
     the claim: one hash exchange) exactly numpy's; ``q1fork6m`` (TPC-H
     Q1's shape over ``fork_on`` branches of one materialized scan)
     within the group bound; ``window6m`` (a 7-row ``sliding_window``
     over ship order: every window exactly numpy's on the held run, the
     moving sum of net within 7 eps sum|v| after); ``partidx6m`` (each
     lineitem's partition index is lo(hash(okey)) % 8).  Each cold, then
     warm and profiled warm in the cold run's context: the orders
     repartition ships the probe's slot cold and the feedback slot warm.
     A vmap fallback to a Python loop over groups fails the phase.  Every
     run's launches match the executor's log, slot probes apart, and
     PageRank's and k-means' supersteps from the second on ship the
     feedback slot;
  3-10. after each of those main-path runs, every kernel call it made
     is made again through the kernel and through its plain version on
     the very tensors the run passed (integers exactly, prefix_sum2
     within twice its bound);
  5. timing: each kernel, its plain version and one library call at the
     largest call of one main-path run (``TIMED_ON``; CUDA events), the
     bound the card's memory rate sets for the same bytes, and a
     torch.profiler breakdown of one warm run of each timed path and of
     TeraSort, PageRank and k-means (a kernel launched in any of them
     that shows no profiled device time in three takes fails the run).
     Per kernel at its timed shape also: the device time per call and the
     device events (kernels, memsets) per call from a profiler window
     around 20 calls, and the host's enqueue time per call (200 calls, no
     sync); for slot_compact, whose call is one exchange's unpack, also a
     loop of one-destination calls on the same tensors (``loop_ms``,
     its device µs per exchange and host enqueue).  Per kernel and path
     (the timed paths, pagerank100k, unnest6m's warm run): the bound of
     the path's captured calls summed beside the path's profiled device
     time (``path_bound`` lines).  The exchange's pack side per exchange
     in the three profiles
     (hist_buckets, slot_expand, copy kernels, the rest of the pack
     range), against its bound, beside the send-buffer copies that the
     batched slot_expand removed, replayed at the same shape.  A kernel
     row's ``launches`` sums its launches over the main-path runs;
     ``runs`` gives each run's own count and |kernel - plain|.

Output: one JSON line per corpus, per GroupByReduce variant, per sort
path, for PageRank and the NaN hold, for k-means and each phase-8,
phase-9 and phase-10 run (each exchanging stage's send-slot rows and
their source per attempt among them), per profile, per pack side and per
kernel, then
the card line, then the
``{"kernels": [...]}`` line, then the result line
``{"ok": true, "device": {...}}`` last.
Long logs (nvcc -Xptxas -v, the profiles) and every JSON line but the
result line (``chip_smoke.jsonl``) go under ``--out`` (default
chiprun_out/).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time
import warnings

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
# the pack side's two batched kernels
PACK = ("hist_buckets", "slot_expand")
# once per hash, range or zip exchange: the two pack kernels and the
# batched unpack
PER_EXCHANGE = PACK + ("slot_compact",)
# the wrapper a kernel's captured calls go through: the exchange's three
# kernels are captured with their batched arguments
CALLS = {"hist_buckets": "hist_buckets_batched",
         "slot_expand": "slot_expand_batched",
         "slot_compact": "slot_compact_batched"}
DEVICE_NAMES = {  # substrings of the compiled kernels' names
    "hist_buckets": ("hist_small", "hist_shared", "hist_global"),
    "prefix_sum": ("scan_lookback",),
    "prefix_sum2": ("scan2_lookback",),
    "slot_expand": ("slot_expand_v4",),
    "slot_compact": ("slot_compact_v2",),
}
PACK_RANGE = "dryad.exchange.pack"   # parallel/shuffle.py's profiler range
# the runs whose calls are kept for a pack_side line
PROFILED = ("zipf50k", "app10k", "terasort1m")


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


def fns(hk, name):
    """(wrapper, plain version) that a kernel's captured calls go
    through."""
    f = CALLS.get(name, name)
    return getattr(hk, f), getattr(hk, f + "_plain")


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
    check_batched(hk, t, rng)
    check_compact(hk, t, rng)

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


def _offsets(rng, P, D, cap):
    """[P, D] exclusive run starts of random counts, with the edges set:
    0, at cap, past cap, negative, and a run reading into the zero pad."""
    offs = np.zeros((P, D), np.int64)
    for p in range(P):
        cnt = rng.randint(0, 2 * cap // D + 2, D)
        offs[p] = np.cumsum(cnt) - cnt
    for i, v in enumerate((cap, cap + 5, -4, cap - 1)):
        offs.flat[(2 * i + 1) % offs.size] = v
    return offs.astype(np.int32)


def check_batched(hk, t, rng) -> None:
    """The exchange's two batched kernels against their plain versions
    (each the per-partition plain version, row by row), exactly.
    slot_expand_batched: P = 1, 3, 8; W = 1, 2, 3, 7, 8; C a multiple of
    4 and not; cap not a multiple of 4; run starts at 0, at cap, past cap
    and negative; the main paths' shapes; and a source misaligned for
    16-byte loads (a contiguous ``words[1:]`` view, W = 7).
    hist_buckets_batched: P = 1, 3, 8; every route (8, 13, 32, 37, 513
    and 20,000 buckets); n from 0 to 1,250,001; negative ids and the
    sentinel; a misaligned view.  Then 50 calls of mixed sizes queued on
    one stream with no sync, each held afterwards, and the kept tickets
    zero again at the end."""
    import torch

    def same(name, got, want, what):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{name} {what}: kernel != plain")

    def rand_words(rows, W, skip=0):
        w = t(rng.randint(-2**31, 2**31 - 1, (rows + skip, W)).astype(
            np.int32))
        return w[skip:]

    cases = [(P, 1003, W, P, C) for P in (1, 3, 8) for W in (1, 2, 3, 7, 8)
             for C in (12, 13)]
    cases += [(3, 501, 7, 5, 1), (8, 65_536, 8, 8, 16_384),
              (8, 250_001, 7, 8, 62_501)]
    for P, cap, W, D, C in cases:
        for skip in ((0, 1) if W == 7 else (0,)):
            words = rand_words(P * cap, W, skip).view(P, cap, W)
            offs = t(_offsets(rng, P, D, cap))
            same("slot_expand", hk.slot_expand_batched(words, offs, C),
                 hk.slot_expand_batched_plain(words, offs, C),
                 f"P={P} cap={cap} W={W} D={D} C={C} skip={skip}")

    def ids(P, n, nb, skip=0):
        b = rng.randint(0, nb, P * n + skip).astype(np.int32)
        b[::7] = nb
        b[::11] = -3
        return t(b)[skip:].view(P, n)

    for P in (1, 3, 8):
        for nb in (8, 13, 32, 37, 513, 20_000):
            for n in (0, 1, 4097, 65_537):
                x = ids(P, n, nb)
                same("hist_buckets", hk.hist_buckets_batched(x, nb),
                     hk.hist_buckets_batched_plain(x, nb),
                     f"P={P} n={n} nb={nb}")
    for P, n, nb, skip in [(1, 1_250_001, 8, 0), (8, 1_250_001, 8, 1),
                           (3, 1_250_001, 37, 1), (8, 65_537, 8, 1)]:
        x = ids(P, n, nb, skip)
        same("hist_buckets", hk.hist_buckets_batched(x, nb),
             hk.hist_buckets_batched_plain(x, nb),
             f"P={P} n={n} nb={nb} skip={skip}")

    sizes = [(8, 65_536, 8), (1, 1_250_001, 8), (3, 4_097, 13),
             (8, 1, 8), (2, 300_000, 32)]
    ins = {s: ids(*s) for s in sizes}
    torch.cuda.synchronize()
    queued = [(s, hk.hist_buckets_batched(ins[s], s[2]))
              for s in sizes * 10]
    torch.cuda.synchronize()
    for i, (s, got) in enumerate(queued):
        same("hist_buckets", got, hk.hist_buckets_batched_plain(ins[s], s[2]),
             f"queued call {i} {s}")
    for tickets, _partials in hk._hist_scratch_bufs.values():
        if tickets.any():
            raise AssertionError("hist_buckets: kept tickets are not zero "
                                 "after their kernels ran")


def _compact_counts(rng, Dd, S, C):
    """[Dd, S] send counts in [-3, C + 3], with the edges set in every
    destination: negative, 0, C and above C."""
    cnt = rng.randint(-3, C + 4, (Dd, S))
    for i, v in enumerate((-2, 0, C, C + 5)):
        cnt[:, (3 * i + 1) % S] = v
    return cnt.astype(np.int32)


def check_compact(hk, t, rng) -> None:
    """The batched compaction against its plain version (each
    destination's ``slot_compact_plain``, stacked), exactly: Dd = 1, 3, 8
    with S = 8 sources, and Dd = 8 at S = 4096; W = 1, 2, 7, 8, 46; C = 1
    and 13; counts negative, 0, C and above C (clamped); out_rows 0,
    below the largest total (truncation), at it and far above it; sources
    misaligned for 16-byte loads (a contiguous ``recv[1:]`` view, W = 7
    and 46); the main paths' shapes (WordCount's token exchange, phase
    10's orders repartition); then 50 calls of mixed sizes queued on one
    stream with no sync, each held afterwards.  Before every call a
    tensor of the output's size filled with 0x7F bytes is allocated and
    freed, so the caching allocator hands that block to the wrapper's
    ``torch.empty``: a word the kernel leaves unwritten shows."""
    import torch

    def recv_of(Dd, S, C, W, skip=0):
        w = rng.randint(-2**31, 2**31 - 1, Dd * S * C * W + skip)
        return t(w.astype(np.int32))[skip:].view(Dd, S * C, W)

    def call(recv, cnt, C, out_rows):
        Dd, _rows, W = recv.shape
        junk = torch.full((Dd, out_rows, W), 0x7F7F7F7F, dtype=torch.int32,
                          device=recv.device)
        del junk
        return hk.slot_compact_batched(recv, cnt, C, out_rows)

    def same(got, want, what):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"slot_compact {what}: kernel != plain")

    cases = [(Dd, 8, C, W, skip) for Dd in (1, 3, 8) for W in (1, 2, 7, 8, 46)
             for C in (1, 13) for skip in ((0, 1) if W in (7, 46) else (0,))]
    cases += [(8, 4096, 3, 7, 0), (8, 4096, 1, 2, 1)]
    for Dd, S, C, W, skip in cases:
        recv = recv_of(Dd, S, C, W, skip)
        cnt = t(_compact_counts(rng, Dd, S, C))
        top = int(cnt.long().clamp(0, C).sum(1).max())
        for out_rows in (0, top // 2, top, 3 * top + 17):
            same(call(recv, cnt, C, out_rows),
                 hk.slot_compact_batched_plain(recv, cnt, C, out_rows),
                 f"Dd={Dd} S={S} C={C} W={W} skip={skip} "
                 f"out_rows={out_rows}")

    # the main paths' shapes: WordCount's token exchange (8 sources of
    # C = 16,384 rows of 8 words into 1,250,000 rows), phase 10's orders
    # repartition (C = 24,576 rows of 46 words, truncated and not)
    for Dd, S, C, W, out_rows in [(8, 8, 16_384, 8, 1_250_000),
                                  (8, 8, 24_576, 46, 187_500),
                                  (8, 8, 24_576, 46, 150_001)]:
        recv = recv_of(Dd, S, C, W)
        cnt = t(rng.randint(C // 2, C + 1, (Dd, S)).astype(np.int32))
        same(call(recv, cnt, C, out_rows),
             hk.slot_compact_batched_plain(recv, cnt, C, out_rows),
             f"Dd={Dd} S={S} C={C} W={W} out_rows={out_rows}")
        del recv

    sizes = [(8, 8, 700, 7, 4000), (1, 8, 13, 46, 100), (3, 8, 1, 1, 5),
             (8, 4096, 2, 3, 9000), (2, 8, 5000, 8, 0)]
    ins = {}
    for Dd, S, C, W, out_rows in sizes:
        ins[(Dd, S, C, W, out_rows)] = (recv_of(Dd, S, C, W, 1), t(
            _compact_counts(rng, Dd, S, C)), C, out_rows)
    torch.cuda.synchronize()
    queued = [(k, call(*ins[k])) for k in sizes * 10]
    torch.cuda.synchronize()
    for i, (k, got) in enumerate(queued):
        same(got, hk.slot_compact_batched_plain(*ins[k]),
             f"queued call {i} {k}")


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
    wrapper, plain = fns(hk, name)
    got = wrapper(*args)
    want = plain(*args)
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


def check_per_exchange(run, launches, attempts=None,
                       broadcasts: int = 0, probes: int = 0) -> None:
    """hist_buckets, slot_expand and slot_compact launch once per hash,
    range or zip exchange; the exchanges are counted from slot_expand,
    which nothing else launches.  A broadcast launches exactly one
    slot_compact and nothing else, so slot_compact must equal the
    exchanges plus ``broadcasts`` (the executor's count of broadcast legs
    times attempts).  A slot probe launches one hist_buckets and nothing
    else, so hist_buckets must equal the exchanges plus ``probes`` (the
    executor's count).  A capacity retry runs the stage's exchanges
    again, and a join stage has up to two exchanging legs, so
    ``attempts``, where given, is the executor's own count of hash /
    range exchanging legs times attempts over its ``stage_log``
    (``exchange_attempts``), which must agree."""
    exchanges = launches["slot_expand"]
    apart = {"hist_buckets": probes, "slot_compact": broadcasts}
    bad = {k: launches[k] for k in PER_EXCHANGE
           if launches[k] - apart.get(k, 0) != exchanges}
    if attempts is not None and attempts != exchanges:
        bad["executor_attempts"] = attempts
    if not (exchanges or broadcasts) or bad:
        raise AssertionError(f"{run}: {exchanges} exchanges, {broadcasts} "
                             f"broadcasts and {probes} probes (slot_compact "
                             f"{launches['slot_compact']}) but launches "
                             f"{bad}: not once per exchange")


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
    just after.  Returns (table, launches, load_s, query_s, [the
    executor's stage log])."""
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
    return (out, dict(hk.launches), t1 - t0, t2 - t1,
            [list(ctx.executor.stage_log)])


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
    just after.  Returns (table, launches, load_s, query_s, [the
    executor's stage log])."""
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
    return (out, dict(hk.launches), t1 - t0, t2 - t1,
            [list(ctx.executor.stage_log)])


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
# phase 6: the sort paths


def sort_runs(ts, gbr, records: int, rows: int) -> dict:
    """name -> ((data, str_max_len), queries, oracle check): TeraSort, a
    descending two-key order_by, top-k and lower median per key, and
    distinct, the last three on the GroupByReduce pairs.  A check returns
    the run's sizes."""

    def tera_check(outs, recs):
        (out,) = outs
        keys = np.array(recs["key"], dtype="S10")    # printable, no NULs
        order = np.lexsort((recs["payload"], keys))
        if (out["key"] != keys[order].tolist()
                or not np.array_equal(out["payload"],
                                      recs["payload"][order])):
            raise AssertionError("terasort1m: not the sorted (key, "
                                 "payload) pairs")
        return {"rows": len(out["key"])}

    def desc_check(outs, d):
        (out,) = outs
        order = np.lexsort((d["v"], -d["k"].astype(np.int64)))
        if not (np.array_equal(out["k"], d["k"][order])
                and np.array_equal(out["v"], d["v"][order])):
            raise AssertionError("orderby_desc2m: not numpy's lexsort "
                                 "order")
        return {"rows": len(out["k"]), "groups": len(np.unique(d["k"]))}

    def topk_check(outs, d):
        topk, med = outs
        k, v = d["k"], d["v"]
        order = np.lexsort((-v.astype(np.float64), k))
        ks = k[order]
        keep = order[np.arange(len(ks)) - np.searchsorted(ks, ks) < 3]
        want = sorted(zip(k[keep].tolist(), v[keep].tolist()))
        if sorted(zip(topk["k"].tolist(), topk["v"].tolist())) != want:
            raise AssertionError("topk10k: top-3 rows differ from numpy")
        order = np.lexsort((v, k))
        ks, vs = k[order], v[order]
        starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        sizes = np.diff(np.r_[starts, len(ks)])
        lower = dict(zip(ks[starts].tolist(),
                         vs[starts + (sizes - 1) // 2].tolist()))
        if (len(med["k"]) != len(lower)
                or dict(zip(med["k"].tolist(), med["v"].tolist())) != lower):
            raise AssertionError("topk10k: lower medians differ from numpy")
        return {"rows": len(k), "groups": len(lower),
                "topk_rows": len(topk["k"])}

    def distinct_check(outs, d):
        (out,) = outs
        keys, first = np.unique(d["k"], return_index=True)
        o = np.argsort(out["k"])
        if not (np.array_equal(out["k"][o], keys)
                and np.array_equal(out["v"][o], d["v"][first])):
            raise AssertionError("distinct10k: not each key's first row")
        return {"rows": len(d["k"]), "groups": len(keys)}

    pairs = (gbr.gen_pairs(rows, 10_000, seed=0), None)
    return {
        "terasort1m": ((ts.gen_records(records, seed=0), 10),
                       [ts.terasort_query], tera_check),
        "orderby_desc2m": (pairs, [lambda ds: ds.order_by(
            [("k", True), ("v", False)])], desc_check),
        "topk10k": (pairs, [lambda ds: ds.group_top_k(["k"], 3, "v"),
                            lambda ds: ds.group_median(["k"], "v")],
                    topk_check),
        "distinct10k": (pairs, [lambda ds: ds.distinct(["k"])],
                        distinct_check),
    }


def run_sort(port, hk, data, str_max_len, queries):
    """One main-path run of a sort path through the user's entry points,
    timed as load (from_columns) and query (each query's plan, stages
    and collect).  Counters zeroed just before, read just after.  Returns
    (tables, launches, load_s, query_s, the executor's stage log of each
    query)."""
    import torch
    ctx = port.Context(device="cuda", nparts=NPARTS)
    hk.reset_launches()
    t0 = time.perf_counter()
    ds = ctx.from_columns(data, str_max_len=str_max_len)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs, logs = [], []
    for q in queries:
        outs.append(q(ds).collect())
        logs.append(list(ctx.executor.stage_log))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return outs, dict(hk.launches), t1 - t0, t2 - t1, logs


def exchanging_stages(logs) -> list:
    """Each exchanging stage of a run: its label, exchange kind, number of
    exchanges (legs and a zip's; broadcast legs among them), retries
    (attempts past the first), final capacity scale, whether it ran
    salted (and how many attempts did), each attempt's send-slot rows of
    each hash / range / zip exchange and their source ("probe",
    "feedback" or "slack"), the slot probes it ran and each exchanging
    leg's received rows per destination."""
    return [{"stage": st["label"], "exchange": st["exchange"],
             "exchanges": st["exchanges"], "broadcasts": st["broadcasts"],
             "retries": st["attempts"] - 1, "scale": st["scale"],
             "salted": st["salted"],
             "salted_attempts": st["salted_attempts"],
             "slot_rows": st["slot_rows"], "slot_source": st["slot_source"],
             "probes": st["probes"], "recv_rows": st["recv_rows"]}
            for log in logs for st in log if st["exchange"]]


def exchange_attempts(stages) -> int:
    """Hash and range exchanges the executor ran over
    ``exchanging_stages``: each such leg once per attempt."""
    return sum((st["retries"] + 1) * (st["exchanges"] - st["broadcasts"])
               for st in stages)


def probes_run(stages) -> int:
    """Slot probes the executor ran over ``exchanging_stages`` (one
    hist_buckets launch each)."""
    return sum(st["probes"] for st in stages)


def broadcast_attempts(stages) -> int:
    """Broadcasts the executor ran over ``exchanging_stages``: broadcast
    legs once per attempt, and a salted join attempt's broadcast of its
    hot right rows (its two hash exchanges count as the stage's two hash
    legs)."""
    return sum((st["retries"] + 1) * st["broadcasts"]
               + st["salted_attempts"] for st in stages)


# ---------------------------------------------------------------------------
# phase 7: PageRank, and NaN min/max


PR_EDGES, PR_ITERS = 1_000_000, 10   # the JAX bench's (bench.py:2038-2045)
PR_RTOL = 2e-3                       # tests/test_apps.py's test_pagerank


def run_app(port, hk, app, device="cuda", ctx=None):
    """One main-path run of ``app(ctx)`` through the user's entry points,
    with the context's ``from_columns`` timed as load and each executor
    run timed and logged.  Counters zeroed just before, read just after.
    ``ctx``: a context to run in (a warm run in the cold run's context
    finds the send slots its stages measured), else a new one.  Returns
    (app's result, launches, load_s, query_s, runs): ``runs`` is one dict
    per executor run (a do_while superstep or not, seconds, stage
    log)."""
    import torch

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    ctx = ctx or port.Context(device=device, nparts=NPARTS)
    load, runs = [0.0], []
    from_columns, run = ctx.from_columns, ctx.executor.run

    def timed_from_columns(*args, **kw):
        t0 = time.perf_counter()
        ds = from_columns(*args, **kw)
        sync()
        load[0] += time.perf_counter() - t0
        return ds

    def logged_run(graph, bindings=None):
        t0 = time.perf_counter()
        out = run(graph, bindings)
        sync()
        runs.append({"superstep": bindings is not None,
                     "s": time.perf_counter() - t0,
                     "stages": list(ctx.executor.stage_log)})
        return out

    ctx.from_columns, ctx.executor.run = timed_from_columns, logged_run
    try:
        hk.reset_launches()
        sync()
        t0 = time.perf_counter()
        out = app(ctx)
        sync()
        wall = time.perf_counter() - t0
    finally:
        # the class's own methods again, for the context's next run
        del ctx.from_columns, ctx.executor.run
    return out, dict(hk.launches), load[0], wall - load[0], runs


def run_pagerank(port, hk, pr, edges, n_nodes, device="cuda"):
    """PageRank's main path (``pagerank()``: from_columns -> join -> cache
    -> do_while -> collect) through ``run_app``."""
    return run_app(port, hk, lambda ctx: pr.pagerank(
        ctx, edges, n_nodes, n_iters=PR_ITERS), device)


def check_pagerank(out, edges, n_nodes, pr) -> dict:
    """The node set is exactly 0..n-1, every rank within PR_RTOL of the
    float64 ``pagerank_numpy``, the ranks sum to 1 within 1e-2."""
    nodes = np.asarray(out["node"])
    ranks = np.asarray(out["rank"], np.float64)
    if len(nodes) != n_nodes or not np.array_equal(np.sort(nodes),
                                                   np.arange(n_nodes)):
        raise AssertionError("pagerank: the node set is not 0..n-1")
    ref = pr.pagerank_numpy(edges, n_nodes, PR_ITERS)
    got = np.empty(n_nodes)
    got[nodes] = ranks
    rel = float((np.abs(got - ref) / np.abs(ref)).max())
    if not rel <= PR_RTOL:
        raise AssertionError(f"pagerank: a rank is {rel:.3g} off "
                             f"pagerank_numpy (rtol {PR_RTOL})")
    total = float(ranks.sum())
    if abs(total - 1.0) > 1e-2:
        raise AssertionError(f"pagerank: the ranks sum to {total}")
    return {"nodes": n_nodes, "max_rel_err": rel, "rank_sum": total}


def loop_stages(runs) -> dict:
    """The executor's log of a job: the exchanging stages of its runs
    outside a do_while loop, each superstep's attempts per stage, and the
    hash / range exchange and broadcast counts (legs x attempts) over all
    runs."""
    outside = [st for r in runs if not r["superstep"]
               for st in exchanging_stages([r["stages"]])]
    steps = [[{"stage": st["label"], "exchanges": st["exchanges"],
               "attempts": st["attempts"], "slot_rows": st["slot_rows"],
               "slot_source": st["slot_source"]} for st in r["stages"]]
             for r in runs if r["superstep"]]
    every = exchanging_stages([r["stages"] for r in runs])
    return {"outside_loop": outside, "supersteps": steps,
            "exchange_attempts": exchange_attempts(every),
            "broadcast_attempts": broadcast_attempts(every),
            "probes": probes_run(every)}


def check_feedback(run, stages) -> None:
    """From the second superstep on, every hash / range exchange of the
    loop's stages ships, at its first attempt, the send slot that the
    same stage measured in the superstep before (source "feedback")."""
    bad = [(i, st["stage"], st["slot_source"][0])
           for i, step in enumerate(stages["supersteps"][1:], 2)
           for st in step if any(s != "feedback"
                                 for s in st["slot_source"][0])]
    if bad or len(stages["supersteps"]) < 2:
        raise AssertionError(f"{run}: (superstep, stage, sources) not "
                             f"shipping the measured slot: {bad}")


def nan_minmax_data(n: int = 400):
    """int32 keys on 24 groups, f32 values with one in ten NaN (numpy seed
    7): 400 rows, 50 a partition."""
    rng = np.random.RandomState(7)
    v = rng.randn(n).astype(np.float32)
    v[rng.rand(n) < 0.1] = np.nan
    return {"k": rng.randint(0, 24, n).astype(np.int32), "v": v}


def nan_minmax_oracle(data) -> dict:
    """key -> (min, max) as f32 bits, by the two stages' lowerings: each
    partition's block (rows split evenly, first blocks one longer) takes
    the min and max in the sort lanes' total order (a positive NaN above
    +inf), the final stage's minimum / maximum propagate a NaN, and a NaN
    result has the bits 0x7FC00000."""
    k, v = data["k"], data["v"]
    blocks = np.array_split(np.arange(len(k)), NPARTS)
    want = {}
    for key in np.unique(k).tolist():
        mins, maxs = [], []
        for b in blocks:
            g = v[b][k[b] == key]
            if len(g):
                nn = g[~np.isnan(g)]
                mins.append(nn.min() if len(nn) else np.nan)
                maxs.append(np.nan if np.isnan(g).any() else g.max())
        mn = np.float32(np.nan if np.isnan(mins).any() else min(mins))
        mx = np.float32(np.nan if np.isnan(maxs).any() else max(maxs))
        want[key] = tuple(int(np.where(np.isnan(x), np.float32(np.nan), x)
                              .view(np.uint32)) for x in (mn, mx))
    return want


def check_nan_minmax(port, device="cuda") -> dict:
    """``group_by(["k"], {"mn": min v, "mx": max v})`` at P = 8 (the final
    stage has two min/max columns: the segmented-scan lowering), then
    ``order_by([("mx", False)])`` of it: bit for bit against
    ``nan_minmax_oracle``, NaN groups last in the order."""
    data = nan_minmax_data()
    want = nan_minmax_oracle(data)
    ctx = port.Context(device=device, nparts=NPARTS)
    g = ctx.from_columns(data).group_by(["k"], {"mn": ("min", "v"),
                                                "mx": ("max", "v")})
    out = g.collect()
    got = {key: (int(a), int(b)) for key, a, b in zip(
        out["k"].tolist(), np.asarray(out["mn"]).view(np.uint32),
        np.asarray(out["mx"]).view(np.uint32))}
    if got != want:
        bad = {key: (got.get(key), w) for key, w in want.items()
               if got.get(key) != w}
        raise AssertionError(f"nan min/max: groups differ from the oracle "
                             f"(key: got, want bits) {bad}")
    srt = np.asarray(g.order_by([("mx", False)]).collect()["mx"])
    mx = np.array([w[1] for w in want.values()], np.uint32).view(np.float32)
    nan = np.isnan(mx)
    order = np.concatenate([np.sort(mx[~nan]), mx[nan]]).view(np.uint32)
    if not np.array_equal(srt.view(np.uint32), order):
        raise AssertionError("nan min/max: order_by of the max is not the "
                             "total order with NaN last")
    return {"groups": len(want), "nan_max_groups": int(nan.sum()),
            "nan_min_groups": int(sum(np.isnan(np.array(
                [w[0] for w in want.values()], np.uint32).view(np.float32))))}


# ---------------------------------------------------------------------------
# phase 8: k-means, the set operators, the broadcast join, the scalars


KM_DIM, KM_K, KM_ITERS = 8, 16, 5    # the JAX bench's (bench.py:2014-2019)
KM_TOL = 1e-3                        # tests/test_apps.py's test_kmeans
SETOPS = ("union", "intersect", "except_", "concat")


def run_kmeans(port, hk, km, pts, device="cuda"):
    """k-means' main path (``kmeans()``: from_columns -> with_capacity ->
    do_while(cross_apply over the broadcast centroids -> group_by mean ->
    with_capacity) -> collect) through ``run_app``; init = the first k
    points."""
    return run_app(port, hk, lambda ctx: km.kmeans(
        ctx, pts, KM_K, n_iters=KM_ITERS), device)


def check_kmeans(cents, pts, km) -> dict:
    """Every cid present (k rows: a cluster that lost every point would
    drop out), each centroid within rtol and atol KM_TOL of the float64
    ``kmeans_numpy``."""
    ref = km.kmeans_numpy(pts, KM_K, KM_ITERS)
    got = np.asarray(cents, np.float64)
    if got.shape != ref.shape:
        raise AssertionError(f"kmeans: {got.shape[0]} centroids, not "
                             f"{KM_K}: a cid is missing")
    dev = np.abs(got - ref)
    if not np.all(dev <= KM_TOL + KM_TOL * np.abs(ref)):
        raise AssertionError(f"kmeans: a centroid is {dev.max():.3g} off "
                             f"kmeans_numpy")
    return {"points": len(pts["x"]), "dim": KM_DIM, "k": KM_K,
            "iters": KM_ITERS, "max_abs_dev": float(dev.max()),
            "max_rel_dev": float((dev / np.abs(ref)).max())}


def setop_tables(n: int):
    """Two tables of ``n`` rows (k int32, tag = k % 97): k drawn with
    replacement, seeds 0 and 1, the left from [0, 2**20), the right from
    [2**19, 2**19 + 2**20): duplicates on both sides, overlapping by
    half."""
    lk = np.random.RandomState(0).randint(0, 2**20, n).astype(np.int32)
    rk = np.random.RandomState(1).randint(2**19, 2**19 + 2**20, n).astype(
        np.int32)
    return ({"k": lk, "tag": lk % 97}, {"k": rk, "tag": rk % 97})


def setop_queries(ctx, left, right) -> dict:
    a, b = ctx.from_columns(left), ctx.from_columns(right)
    return {op: getattr(a, op)(b).collect() for op in SETOPS}


def check_setops(outs, left, right) -> dict:
    """Each operator's rows against numpy: a row is fixed by k (tag = k %
    97 everywhere), so union / intersect / except_ must hold exactly
    numpy's sorted set of keys, each once, and concat the multiset of
    both sides' keys."""
    lk, rk = left["k"], right["k"]
    want = {"union": np.union1d(lk, rk), "intersect": np.intersect1d(lk, rk),
            "except_": np.setdiff1d(lk, rk),
            "concat": np.sort(np.concatenate([lk, rk]))}
    rows = {}
    for op in SETOPS:
        k, tag = np.asarray(outs[op]["k"]), np.asarray(outs[op]["tag"])
        if not np.array_equal(tag, k % 97):
            raise AssertionError(f"setops {op}: a row's tag is not k % 97")
        if not np.array_equal(np.sort(k), want[op]):
            raise AssertionError(f"setops {op}: the rows differ from "
                                 f"numpy's")
        rows[op] = len(k)
    return {"rows_each": len(lk), "out_rows": rows}


def bcast_tables(gbr, rows: int):
    """The GroupByReduce pairs (``gen_pairs(rows, 10,000)``, seed 0) and a
    10,000-row unique-keyed table (k, w = 3k + 1)."""
    k = np.arange(10_000, dtype=np.int32)
    return gbr.gen_pairs(rows, 10_000, seed=0), {"k": k, "w": 3 * k + 1}


def bcast_join(ctx, left, right, broadcast: bool = True):
    return ctx.from_columns(left).join(ctx.from_columns(right), ["k"],
                                       broadcast=broadcast).collect()


def _sorted_rows(t, cols):
    """A table's columns in one canonical row order (a multiset)."""
    order = np.lexsort([np.asarray(t[c]).view(np.int32) for c in cols])
    return [np.asarray(t[c])[order] for c in cols]


def check_bcast_join(out, hashed, left) -> dict:
    """The broadcast join as a multiset: equal to the same join planned
    with hash exchanges, and to numpy's (every left row once, w = 3k +
    1)."""
    cols = ("k", "v", "w")
    got = _sorted_rows(out, cols)
    want = _sorted_rows({**left, "w": 3 * left["k"] + 1}, cols)
    for name, other in (("the hash-join plan's", _sorted_rows(hashed, cols)),
                        ("numpy's", want)):
        if not all(np.array_equal(a.view(np.int32), b.view(np.int32))
                   for a, b in zip(got, other)):
            raise AssertionError(f"bcastjoin: rows differ from {name}")
    return {"rows": len(got[0]), "right_rows": 10_000}


def scalar_queries(port, ctx, data, nan_data) -> dict:
    """Every terminal scalar on the GroupByReduce pairs, and min / max of
    the NaN data's f32 column."""
    ds = ctx.from_columns(data)
    flags = ds.select(lambda c: {"pos": c["v"] > 0,
                                 "big": c["v"] > -100})
    nan = ctx.from_columns(nan_data)
    stats = port_stats(port)
    return {
        "count": ds.count(), "first": ds.first(),
        "sum_k": ds.sum("k"), "min_k": ds.min("k"), "max_k": ds.max("k"),
        "sum_v": ds.sum("v"), "mean_v": ds.mean("v"),
        "min_v": ds.min("v"), "max_v": ds.max("v"),
        "any_pos": flags.any("pos"), "all_pos": flags.all("pos"),
        "all_big": flags.all("big"),
        "nan_min": nan.min("v"), "nan_max": nan.max("v"),
        "aggregate": ds.aggregate(stats),
    }


def port_stats(port):
    """A user Decomposable: count, sum, min and max of ``v``."""
    import torch

    def seed(c):
        v = c["v"]
        return (torch.ones(v.shape[0], dtype=torch.int32, device=v.device),
                v, v, v)
    return port.Decomposable(
        seed, lambda a, b: (a[0] + b[0], a[1] + b[1],
                            torch.minimum(a[2], b[2]),
                            torch.maximum(a[3], b[3])),
        lambda s: {"n": s[0], "s": s[1], "lo": s[2], "hi": s[3]})


def check_scalars(got, data, nan_data) -> dict:
    """Against numpy: the f32 sum and mean within the GroupByReduce bound
    (16 eps sum|v|, over n for the mean), the rest exactly, NaN min / max
    with numpy's bits."""
    k, v = data["k"], data["v"]
    v64 = v.astype(np.float64)
    bound = 16 * EPS * float(np.abs(v64).sum())
    exact = {"count": len(k), "sum_k": int(k.astype(np.int64).sum()),
             "min_k": int(k.min()), "max_k": int(k.max()),
             "min_v": v.min(), "max_v": v.max(),
             "any_pos": bool((v > 0).any()), "all_pos": bool((v > 0).all()),
             "all_big": bool((v > -100).all())}
    bad = [n for n, w in exact.items() if not got[n] == w]
    first = got["first"]
    if int(first["k"]) != int(k[0]) or np.float32(first["v"]) != v[0]:
        bad.append("first")
    if not abs(float(got["sum_v"]) - v64.sum()) <= bound:
        bad.append("sum_v")
    if not abs(float(got["mean_v"]) - v64.mean()) <= bound / len(v):
        bad.append("mean_v")
    for name in ("nan_min", "nan_max"):
        want = getattr(np, name[4:])(nan_data["v"])
        if np.float32(got[name]).view(np.uint32) != np.float32(want).view(
                np.uint32):
            bad.append(name)
    agg = got["aggregate"]
    if not (int(agg["n"]) == len(k) and agg["lo"] == v.min()
            and agg["hi"] == v.max()
            and abs(float(agg["s"]) - v64.sum()) <= bound):
        bad.append("aggregate")
    if bad:
        raise AssertionError(f"scalars: {bad} differ from numpy")
    return {"rows": len(k), "scalars": len(got),
            "sum_v_err": abs(float(got["sum_v"]) - v64.sum()),
            "sum_v_bound": bound}


# ---------------------------------------------------------------------------
# phase 9: skewed joins, outer joins and group_join, the positional
# operators


HOT_FRAC = 0.9                       # the JAX bench's skew (bench.py:357-360)


def tpch_tables(n_items: int, seed: int = 0):
    """LINEITEM, ORDERS and CUSTOMER at TPC-H's proportions (spec §4.2.3:
    SF1 is 6,000,000 / 1,500,000 / 150,000 rows), numpy seed ``seed``.
    lineitem: ``okey`` 0 with probability 0.9, else uniform in
    [1, n_orders) (the JAX bench's skew), ``price`` in [1, 100), ``qty``
    in [1, 10).  orders: ``okey`` = arange, ``flag`` = okey % 2,
    ``custkey`` uniform over [1, n_cust] and never divisible by 3 (as
    O_CUSTKEY), ``prio`` in [0, 5), ``totalprice`` f32 in [850, 550,000).
    customer: ``custkey`` = 1..n_cust, ``seg`` in [0, 5)."""
    rng = np.random.RandomState(seed)
    n_orders, n_cust = n_items // 4, n_items // 40
    okey = np.where(rng.rand(n_items) < HOT_FRAC, 0,
                    rng.randint(1, n_orders, n_items)).astype(np.int32)
    li = {"okey": okey,
          "price": rng.randint(1, 100, n_items).astype(np.int32),
          "qty": rng.randint(1, 10, n_items).astype(np.int32)}
    ck = np.arange(1, n_cust + 1, dtype=np.int32)
    allowed = ck[ck % 3 != 0]
    ok = np.arange(n_orders, dtype=np.int32)
    orders = {"okey": ok, "flag": ok % 2,
              "custkey": allowed[rng.randint(0, len(allowed), n_orders)],
              "prio": rng.randint(0, 5, n_orders).astype(np.int32),
              "totalprice": rng.uniform(850, 550_000, n_orders).astype(
                  np.float32)}
    cust = {"custkey": ck, "seg": rng.randint(0, 5, n_cust).astype(np.int32)}
    return li, orders, cust


def skew_join_query(ctx, li, orders, by: str) -> dict:
    """bench.py's skewed join (lineitem joined with orders on okey,
    flag == 0, rev = price * qty), grouped by ``by``: "custkey" (top
    customers by revenue: the group-by exchanges, so the join's placement
    is not relied on and the join may salt) or "okey" (bench.py's own
    query: the group-by trusts the join's placement, so it must not).
    The group-by is cached, then collected whole and as its top 10 by
    revenue (ties by key)."""
    j = ctx.from_columns(li).join(ctx.from_columns(orders), ["okey"]).where(
        lambda c: c["flag"] == 0).select(
        lambda c: {by: c[by], "rev": c["price"] * c["qty"]})
    g = j.group_by([by], {"revenue": ("sum", "rev"),
                          "n": ("count", None)}).cache()
    return {"groups": g.collect(),
            "top": g.order_by([("revenue", True), (by, False)]).take(
                10).collect()}


def join_stage(runs) -> dict:
    """The executor's log entry of the one join stage of a job."""
    (st,) = [s for r in runs for s in r["stages"] if s["label"] == "join"]
    return st


def check_skew_join(out, li, orders, by: str, runs, salted: bool) -> dict:
    """Against numpy exactly: every group's int32 revenue (int64 sums,
    each below 2**31) and count, and the top 10 by (revenue desc, key).
    The join stage, by the executor's log: with ``salted``, it overflowed
    once unsalted and ran salted at the second attempt, at a scale x
    capacity below N / 2, every partition receiving fewer than 2N / P
    left rows; without, it never salted and retried once at the
    measured scale."""
    okey = li["okey"]
    keep = orders["flag"][okey] == 0
    key = orders[by][okey[keep]]
    rev = li["price"][keep].astype(np.int64) * li["qty"][keep]
    m = int(key.max()) + 1
    cnt = np.bincount(key, minlength=m)
    keys = np.flatnonzero(cnt)
    sums = np.zeros(m, np.int64)
    np.add.at(sums, key, rev)
    want = sums[keys]
    if not want.max() < 2**31:
        raise AssertionError(f"{by}: a revenue passes 2**31: no int32 "
                             f"oracle")
    g = out["groups"]
    o = np.argsort(g[by])
    if not (np.array_equal(g[by][o], keys)
            and np.array_equal(g["revenue"][o], want)
            and np.array_equal(g["n"][o], cnt[keys])):
        raise AssertionError(f"skew join by {by}: groups differ from numpy")
    top = np.lexsort((keys, -want))[:10]
    t = out["top"]
    if not (np.array_equal(t[by], keys[top])
            and np.array_equal(t["revenue"], want[top])):
        raise AssertionError(f"skew join by {by}: the top 10 differ from "
                             f"numpy")
    st = join_stage(runs)
    n, P = len(okey), NPARTS
    cap = -(-n // P)
    ok = (st["salted"] and st["attempts"] == 2 and st["salted_attempts"] == 1
          and st["scale"] * cap < n / 2
          and max(st["recv_rows"][0]) < 2 * n / P) if salted else (
        st["attempts"] == 2 and not any(
            s["salted"] for r in runs for s in r["stages"]))
    if not ok:
        raise AssertionError(f"skew join by {by}: the join stage "
                             f"{st} is not as predicted")
    return {"lineitems": n, "orders": len(orders["okey"]),
            "groups": len(keys), "hot_revenue": int(want.max()),
            "join_attempts": st["attempts"], "join_salted": st["salted"],
            "join_scale": st["scale"], "join_slack": st["slack"],
            "join_recv_rows": st["recv_rows"]}


def q13_queries(ctx, orders, cust) -> dict:
    """The TPC-H Q13 shape: each customer's count and f32 spend of the
    orders with prio != 0 by ``group_join`` (cached), the count of
    customers per count (custdist); the same counts through a right join
    with the orders' aggregate on the left; the seg-0 customers full-
    joined with the prio-0 orders' per-customer aggregate."""
    o, c = ctx.from_columns(orders), ctx.from_columns(cust)
    aggs = {"n": ("count", None), "spend": ("sum", "totalprice")}
    prio = o.where(lambda x: x["prio"] != 0)
    per = c.group_join(prio, ["custkey"], aggs).cache()
    return {
        "per_customer": per.collect(),
        "custdist": per.group_by(["n"], {"custdist": ("count", None)}
                                 ).collect(),
        "right": prio.group_by(["custkey"], {"n": ("count", None)}).join(
            c, ["custkey"], how="right").collect(),
        "full": c.where(lambda x: x["seg"] == 0).join(
            o.where(lambda x: x["prio"] == 0).group_by(["custkey"], aggs),
            ["custkey"], how="full").collect(),
    }


def _per_customer(orders, sel, n_cust):
    """(count, f32 sum as float64, its bound) per custkey 0..n_cust of the
    selected orders: 16 eps sum_group|v| + 16 eps^2 sum|v|, as for
    GroupByReduce."""
    ck = orders["custkey"][sel]
    v = orders["totalprice"][sel].astype(np.float64)
    n = np.bincount(ck, minlength=n_cust + 1)
    s = np.bincount(ck, weights=v, minlength=n_cust + 1)
    bound = (16 * EPS * np.bincount(ck, weights=np.abs(v),
                                    minlength=n_cust + 1)
             + 16 * EPS**2 * float(np.abs(v).sum()))
    return n, s, bound


def check_q13(out, orders, cust) -> dict:
    """Against numpy: custkeys and counts exactly, f32 spends within the
    bound; every customer in the group_join and right join (those with no
    order counted 0); the full join holds the seg-0 customers with no
    prio-0 order (unmatched left) and the customers of prio-0 orders
    outside seg 0 (unmatched right, seg zero-filled)."""
    n_cust = len(cust["custkey"])
    seg = np.zeros(n_cust + 1, np.int32)
    seg[cust["custkey"]] = cust["seg"]
    n, s, bound = _per_customer(orders, orders["prio"] != 0, n_cust)
    bad = []
    per = out["per_customer"]
    o = np.argsort(per["custkey"])
    k = per["custkey"][o]
    if not (np.array_equal(k, cust["custkey"])
            and np.array_equal(per["n"][o], n[k])
            and np.array_equal(per["seg"][o], seg[k])
            and (np.abs(per["spend"][o] - s[k]) <= bound[k]).all()):
        bad.append("group_join")
    cd = out["custdist"]
    want = np.bincount(n[1:])
    got = np.zeros(max(len(want), int(cd["n"].max()) + 1), np.int64)
    got[cd["n"]] = cd["custdist"]
    if not np.array_equal(got[:len(want)], want) or got[len(want):].any():
        bad.append("custdist")
    r = out["right"]
    o = np.argsort(r["custkey"])
    k = r["custkey"][o]
    if not (np.array_equal(k, cust["custkey"])
            and np.array_equal(r["n"][o], n[k])
            and np.array_equal(r["seg"][o], seg[k])):
        bad.append("right join")
    n0, s0, b0 = _per_customer(orders, orders["prio"] == 0, n_cust)
    left = cust["custkey"][cust["seg"] == 0]
    right = np.flatnonzero(n0)
    f = out["full"]
    o = np.argsort(f["custkey"])
    k = f["custkey"][o]
    unmatched_l = np.setdiff1d(left, right)
    unmatched_r = np.setdiff1d(right, left)
    if not (np.array_equal(k, np.union1d(left, right))
            and not f["seg"].any()
            and np.array_equal(f["n"][o], n0[k])
            and (np.abs(f["spend"][o] - s0[k]) <= b0[k]).all()
            and len(unmatched_l) and len(unmatched_r)):
        bad.append("full join")
    if bad:
        raise AssertionError(f"q13_outer: {bad} differ from numpy")
    return {"customers": n_cust, "orders": len(orders["okey"]),
            "custdist_rows": len(cd["n"]), "zero_order_customers":
            int((n[1:] == 0).sum()), "full_rows": len(k),
            "full_unmatched_left": len(unmatched_l),
            "full_unmatched_right": len(unmatched_r),
            "max_spend_err": float(np.abs(per["spend"][np.argsort(
                per["custkey"])] - s[1:]).max())}


def zip_bounds(n: int):
    """(skip, take_while's row-index end, skip_while's row-index start):
    1,000,000, 4,000,000 and 2,000,000 at 6,000,000 lineitems."""
    return n // 6, 2 * n // 3, n // 3


def zip_queries(ctx, li) -> dict:
    """The lineitems with qty > 4 zipped with those with price > 50 (sides
    with different per-partition counts), a row index, skip, take_while;
    and skip_while over a row index of all lineitems."""
    skip, until, start = zip_bounds(len(li["okey"]))
    d = ctx.from_columns(li)
    z = d.where(lambda c: c["qty"] > 4).zip_with(
        d.where(lambda c: c["price"] > 50)).with_row_index().skip(
        skip).take_while(lambda c: c["row_index"] < until)
    return {"zip": z.collect(),
            "skip_while": d.with_row_index().skip_while(
                lambda c: c["row_index"] < start).collect()}


def check_zip(out, li) -> dict:
    """In global row order against numpy, exactly."""
    n = len(li["okey"])
    skip, until, start = zip_bounds(n)
    a = np.flatnonzero(li["qty"] > 4)
    b = np.flatnonzero(li["price"] > 50)
    m = min(len(a), len(b))
    rows = slice(skip, min(m, until))
    z, w = out["zip"], out["skip_while"]
    bad = [c for c in li if not (
        np.array_equal(z[c], li[c][a[:m]][rows])
        and np.array_equal(z[c + "_r"], li[c][b[:m]][rows])
        and np.array_equal(w[c], li[c][start:]))]
    if not (np.array_equal(z["row_index"], np.arange(skip, min(m, until)))
            and np.array_equal(w["row_index"], np.arange(start, n))):
        bad.append("row_index")
    if bad:
        raise AssertionError(f"zip6m: {bad} differ from numpy")
    return {"lineitems": n, "zip_pairs": m, "zip_rows": len(z["okey"]),
            "skip_while_rows": len(w["okey"])}


def phase9_runs(li, orders, cust) -> dict:
    """label -> (app(ctx), check(out, runs), rows for rows/s, kernels the
    run must launch)."""
    q13_kernels = EXCHANGE + ("prefix_sum2",)
    return {
        "skewjoin6m": (
            lambda ctx: skew_join_query(ctx, li, orders, "custkey"),
            lambda out, runs: check_skew_join(out, li, orders, "custkey",
                                              runs, salted=True),
            len(li["okey"]), EXCHANGE),
        "skewjoin6m_relied": (
            lambda ctx: skew_join_query(ctx, li, orders, "okey"),
            lambda out, runs: check_skew_join(out, li, orders, "okey",
                                              runs, salted=False),
            len(li["okey"]), EXCHANGE),
        "q13_outer": (lambda ctx: q13_queries(ctx, orders, cust),
                      lambda out, runs: check_q13(out, orders, cust),
                      len(orders["okey"]), q13_kernels),
        "zip6m": (lambda ctx: zip_queries(ctx, li),
                  lambda out, runs: check_zip(out, li), len(li["okey"]),
                  EXCHANGE),
    }


# ---------------------------------------------------------------------------
# phase 10: the unnest-and-regroup path


LINES = 7                            # TPC-H: 1 to 7 lineitems an order
LINE_COLS = ("qty", "price", "disc", "shipdate", "flag", "status")
# the warning torch.func.vmap gives where an op has no batching rule and
# it loops over the batch in Python instead
VMAP_FALLBACK = ("There is a performance drop because we have not yet "
                 "implemented the batching rule")
Q1_AGGS = {"sum_qty": ("sum", "qty"), "sum_base_price": ("sum", "price"),
           "sum_disc_price": ("sum", "net"), "avg_disc": ("mean", "disc"),
           "count_order": ("count", None)}


def nested_orders(n_orders: int, seed: int = 0) -> dict:
    """ORDERS with its LINEITEMs nested, at TPC-H's cardinalities (spec
    §4.2.3: SF1 is 1,500,000 orders of 1 to 7 lineitems, uniformly, about
    6,000,000 in all), numpy seed ``seed``.  Per order: ``okey`` =
    arange, ``custkey`` uniform over [1, n_orders / 10], ``nlines`` in
    [1, 7], ``odate`` (days) in [0, 2406); per order and line slot, [n, 7]
    arrays: ``qty`` in [1, 50], ``price`` = qty x a part price in
    [900, 2000) (f32), ``disc`` in {0.00, 0.01, ..., 0.10} (f32),
    ``shipdate`` = odate + [1, 121], ``flag`` in {0, 1, 2} (A / N / R),
    ``status`` in {0, 1}.  Slots past ``nlines`` hold values no query may
    see.  46 four-byte words an order."""
    rng = np.random.RandomState(seed)
    shape = (n_orders, LINES)
    odate = rng.randint(0, 2406, n_orders).astype(np.int32)
    qty = rng.randint(1, 51, shape).astype(np.int32)
    part = (rng.randint(90_000, 200_000, shape) / 100).astype(np.float32)
    return {"okey": np.arange(n_orders, dtype=np.int32),
            "custkey": rng.randint(1, max(2, n_orders // 10 + 1),
                                   n_orders).astype(np.int32),
            "nlines": rng.randint(1, LINES + 1, n_orders).astype(np.int32),
            "odate": odate, "qty": qty,
            "price": qty.astype(np.float32) * part,
            "disc": (rng.randint(0, 11, shape) / 100).astype(np.float32),
            "shipdate": (odate[:, None]
                         + rng.randint(1, 122, shape)).astype(np.int32),
            "flag": rng.randint(0, 3, shape).astype(np.int32),
            "status": rng.randint(0, 2, shape).astype(np.int32)}


def flat_lineitems(orders) -> dict:
    """The numpy unnest: every order's first ``nlines`` line slots as rows
    (order by order, line 1 first), with ``net`` = price * (1 - disc) in
    f32 as the query computes it."""
    live = np.arange(1, LINES + 1)[None, :] <= orders["nlines"][:, None]
    li = {"okey": np.broadcast_to(orders["okey"][:, None], live.shape)[live],
          "line": np.broadcast_to(np.arange(1, LINES + 1, dtype=np.int32),
                                  live.shape)[live]}
    li.update({k: orders[k][live] for k in LINE_COLS})
    li["net"] = li["price"] * (np.float32(1) - li["disc"])
    return li


def li_capacity(n_orders: int) -> int:
    """flat_map's rows a partition: 4.25 lines an order (the mean is 4)."""
    return -(-n_orders * 17 // (4 * NPARTS))


def max_groups(n_orders: int) -> int:
    """group_apply's groups a partition: 1.25 x the orders a partition."""
    return -(-n_orders * 5 // (4 * NPARTS))


def unnest(c):
    """SelectMany(o => o.Lines): each order's 7 line slots as [n, 7]
    columns, the first ``nlines`` of them kept."""
    import torch
    okey = c["okey"]
    n = okey.shape[0]
    line = torch.arange(1, LINES + 1, dtype=torch.int32, device=okey.device)
    out = {"okey": okey[:, None].expand(n, LINES),
           "line": line[None, :].expand(n, LINES)}
    out.update({k: c[k] for k in LINE_COLS})
    return out, line[None, :] <= c["nlines"][:, None]


def add_net(b):
    """net = price * (1 - disc), per partition."""
    return b.with_columns({"net": b.columns["price"]
                           * (1 - b.columns["disc"])})


def top2_by_net(cols, count):
    """ROW_NUMBER() OVER (PARTITION BY okey ORDER BY net DESC, line) <= 2
    for ONE order: a line's rank is the number of the order's lines
    before it in (net desc, line) order, unique since lines are; the
    lines of rank 0 and 1 are emitted.  Comparisons, a sum and argmax
    only: every op has a vmap batching rule."""
    import torch
    net, line = cols["net"], cols["line"]
    slot = torch.arange(net.shape[0], device=net.device)
    live = slot < count
    before = live[None, :] & ((net[None, :] > net[:, None])
                              | ((net[None, :] == net[:, None])
                                 & (line[None, :] < line[:, None])))
    rank = before.sum(dim=1)
    top = torch.stack([torch.argmax((live & (rank == r)).to(torch.int32))
                       for r in (0, 1)])
    return ({k: torch.gather(v, 0, top) for k, v in cols.items()
             if k != "okey"}, slot[:2] < count)


def tag_partition(b, index):
    """The partition's index on every row."""
    import torch
    return b.with_columns({"part": torch.full(
        (b.capacity,), index, dtype=torch.int32, device=b.device)})


def lineitems(ctx, orders, claim: bool = True):
    """The orders hash-repartitioned by okey (a pure hash leg: the slot
    probe's), unnested, claimed hash-placed by okey (true: a line stays
    on its order's partition) unless ``claim`` is off, with net added by
    a per-partition fn that keeps the claim."""
    n = len(orders["okey"])
    li = ctx.from_columns(orders).hash_partition(["okey"]).flat_map(
        unnest, li_capacity(n))
    if claim:
        li = li.assume_hash_partition(["okey"])
    return li.apply_per_partition(add_net, preserves_partitioning=True)


def unnest_query(ctx, orders, claim: bool) -> dict:
    """Each order's top two lines by net (ties by line)."""
    return lineitems(ctx, orders, claim).group_apply(
        ["okey"], top2_by_net, group_capacity=8, out_rows=2,
        max_groups=max_groups(len(orders["okey"]))).collect()


def q1fork_query(ctx, orders) -> dict:
    """TPC-H Q1's shape over one shared scan: the lineitems forked by
    flag, each branch grouped by status (sums, mean, count), the three
    tagged with their flag and concatenated into one plan."""
    import torch
    branches = lineitems(ctx, orders).fork_on("flag", [0, 1, 2])
    outs = [b.group_by(["status"], Q1_AGGS).select(
        lambda c, f=f: dict(c, flag=torch.full_like(c["status"], f)))
        for f, b in enumerate(branches)]
    return outs[0].concat(outs[1]).concat(outs[2]).collect()


def window_query(ctx, orders, held: bool) -> dict:
    """ROWS BETWEEN 6 PRECEDING AND CURRENT ROW over ship order: the
    lineitems sorted by (shipdate, okey, line), unique, so every window
    is defined; whole windows on a held run, else their moving sum of
    net (so collect copies no [N, 7] columns)."""
    w = lineitems(ctx, orders).select(
        lambda c: {k: c[k] for k in ("shipdate", "okey", "line", "net")}
    ).order_by([("shipdate", False), ("okey", False),
                ("line", False)]).sliding_window(LINES)
    if not held:
        w = w.select(lambda c: {"shipdate": c["shipdate"][:, 0],
                                "okey": c["okey"][:, 0],
                                "line": c["line"][:, 0],
                                "msum": c["net"].sum(dim=1)})
    return w.collect()


def partidx_query(ctx, orders) -> dict:
    """Each lineitem's okey and the index of the partition it lies on."""
    return lineitems(ctx, orders).apply_with_partition_index(
        tag_partition).select(lambda c: {"okey": c["okey"],
                                         "part": c["part"]}).collect()


def _stages(runs) -> list:
    return [st for r in runs for st in r["stages"]]


def check_probe(label, runs, n_orders: int, warm: bool) -> dict:
    """The orders repartition (a pure hash leg of 46 words x 1.5 M rows):
    its first attempt ships the probe's slot on a cold run, the slot its
    last run measured on a warm one, below the structural
    ceil(2 cap / P)."""
    (st,) = [s for s in _stages(runs) if s["label"] == "hashpartition"]
    c_struct = -(-2 * -(-n_orders // NPARTS) // NPARTS)
    want = "feedback" if warm else "probe"
    if st["slot_source"][0] != [want] or not st["slot_rows"][0][0] < c_struct:
        raise AssertionError(f"{label}: the orders repartition shipped "
                             f"{st['slot_rows'][0]} from "
                             f"{st['slot_source'][0]}, not {want} below "
                             f"{c_struct}")
    return {"orders_slot_rows": st["slot_rows"],
            "orders_slot_source": st["slot_source"],
            "orders_structural_slot": c_struct}


def top2_oracle(li) -> dict:
    """numpy's top two lines of each order by (net desc, line), sorted by
    (okey, line)."""
    o = np.lexsort((li["line"], -li["net"], li["okey"]))
    k = li["okey"][o]
    rank = np.arange(len(k)) - np.searchsorted(k, k)
    keep = o[rank < 2]
    keep = keep[np.lexsort((li["line"][keep], li["okey"][keep]))]
    return {c: v[keep] for c, v in li.items()}


def check_unnest(label, out, runs, want, n_orders, claim, warm) -> dict:
    """Exactly numpy's top two lines of every order, every carried value;
    the group_apply stage runs with no exchange under the claim and with
    one hash exchange without it; the probe as ``check_probe``."""
    o = np.lexsort((out["line"], out["okey"]))
    bad = [c for c in want
           if not np.array_equal(np.asarray(out[c])[o], want[c])]
    if sorted(out) != sorted(want) or bad:
        raise AssertionError(f"{label}: {bad or sorted(out)} differ from "
                             f"numpy's top two lines")
    ga = [s for s in _stages(runs) if s["label"] == "group_apply"]
    if claim and ga or not claim and [s["exchange"] for s in ga] != ["hash"]:
        raise AssertionError(f"{label}: the group_apply stage's exchange "
                             f"{ga} is not as the claim says")
    return {"orders": n_orders, "rows_out": len(o),
            # the dense [G, 8] regroup of every column, all partitions
            "regroup_bytes": NPARTS * max_groups(n_orders) * 8 * 4 * len(
                want),
            **check_probe(label, runs, n_orders, warm)}


def check_q1(out, li, runs, n_orders, warm) -> dict:
    """Counts and integer sums exactly; f32 sums within 16 eps sum|v|
    over the group, the mean within that over its count; ``li``
    materialized by ONE stage (the tee of the fork's shared parent)."""
    bad = []
    seen = set()
    for i, (f, st) in enumerate(zip(out["flag"].tolist(),
                                    out["status"].tolist())):
        g = (li["flag"] == f) & (li["status"] == st)
        seen.add((f, st))
        n = int(g.sum())
        if (int(out["count_order"][i]) != n
                or int(out["sum_qty"][i]) != int(li["qty"][g].sum())):
            bad.append((f, st, "count / sum_qty"))
        for col, src in (("sum_base_price", "price"),
                         ("sum_disc_price", "net"), ("avg_disc", "disc")):
            v = li[src][g].astype(np.float64)
            bound = 16 * EPS * np.abs(v).sum()
            want = v.sum()
            if col == "avg_disc":
                want, bound = want / n, bound / n
            if not abs(float(out[col][i]) - want) <= bound:
                bad.append((f, st, col))
    if bad or seen != {(f, s) for f in range(3) for s in range(2)}:
        raise AssertionError(f"q1fork6m: {bad or seen} differ from numpy")
    tees = [s["label"] for s in _stages(runs)
            if s["label"].startswith("tee")]
    labels = [s["label"] for s in _stages(runs)]
    if tees != ["tee:ApplyPerPartition"] or len(labels) != 7:
        raise AssertionError(f"q1fork6m: stages {labels}: the shared "
                             f"lineitems not materialized once")
    return {"groups": len(out["flag"]), "stages": labels,
            **check_probe("q1fork6m", runs, n_orders, warm)}


def window_oracle(li) -> dict:
    """The four columns sorted by (shipdate, okey, line)."""
    o = np.lexsort((li["line"], li["okey"], li["shipdate"]))
    return {c: li[c][o] for c in ("shipdate", "okey", "line", "net")}


def check_window(out, want, runs, n_orders, held, warm) -> dict:
    """Held: every window equals numpy's sliding_window_view of the
    sorted columns, exactly, N - 6 of them.  Else each window's first
    row exactly, and its f32 moving sum of net within 7 eps sum|v| of
    numpy's sum in window order."""
    view = np.lib.stride_tricks.sliding_window_view
    n = len(want["okey"]) - LINES + 1
    if held:
        bad = [c for c in want
               if not np.array_equal(np.asarray(out[c]), view(want[c],
                                                              LINES))]
    else:
        bad = [c for c in ("shipdate", "okey", "line")
               if not np.array_equal(np.asarray(out[c]), want[c][:n])]
        w = view(want["net"], LINES)
        s = w[:, 0].copy()
        for j in range(1, LINES):
            s = s + w[:, j]
        err = np.abs(np.asarray(out["msum"], np.float64) - s)
        if not (len(err) == n and (err <= LINES * EPS * np.abs(w).astype(
                np.float64).sum(1)).all()):
            bad.append("msum")
    if bad:
        raise AssertionError(f"window6m: {bad} differ from numpy's "
                             f"windows")
    return {"windows": n, "held": held,
            **check_probe("window6m", runs, n_orders, warm)}


def check_partidx(out) -> dict:
    """Every lineitem lies on partition lo(hash(okey)) % P, the port's
    hash computed on the CPU: the assume_hash_partition claim was true."""
    import torch
    from dryad_tpu_torch.ops.hashing import hash_columns
    okey = np.asarray(out["okey"])
    lo = hash_columns([torch.from_numpy(okey)])[1].numpy()
    if not np.array_equal(np.asarray(out["part"]), lo % NPARTS):
        raise AssertionError("partidx6m: a lineitem lies off its order's "
                             "hash partition")
    return {"lineitems": len(okey),
            "per_partition": np.bincount(lo % NPARTS).tolist()}


def phase10_runs(orders, li) -> dict:
    """label -> (cold app(ctx), warm app(ctx) or None for no warm run,
    check(out, runs, warm), kernels the run must launch).  A warm run
    goes in the cold run's context."""
    n = len(orders["okey"])
    top2 = top2_oracle(li)
    win = window_oracle(li)

    def unnest_run(label, claim):
        app = lambda ctx: unnest_query(ctx, orders, claim)  # noqa: E731
        return (app, app, lambda out, runs, warm: check_unnest(
            label, out, runs, top2, n, claim, warm), EXCHANGE)

    q1 = lambda ctx: q1fork_query(ctx, orders)  # noqa: E731
    return {
        "unnest6m": unnest_run("unnest6m", True),
        "unnest6m_shuffled": unnest_run("unnest6m_shuffled", False),
        "q1fork6m": (q1, q1, lambda out, runs, warm: check_q1(
            out, li, runs, n, warm), EXCHANGE + ("prefix_sum2",)),
        "window6m": (
            lambda ctx: window_query(ctx, orders, True),
            lambda ctx: window_query(ctx, orders, False),
            lambda out, runs, warm: check_window(
                out, win, runs, n, not warm, warm), EXCHANGE),
        "partidx6m": (lambda ctx: partidx_query(ctx, orders), None,
                      lambda out, runs, warm: check_partidx(out),
                      EXCHANGE),
    }


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
        bid, nb = args      # [P, n]
        return 4 * bid.numel() + 4 * bid.shape[0] * nb, bid.numel()
    if name == "prefix_sum":
        (x,) = args
        return 8 * x.numel(), x.numel()
    if name == "prefix_sum2":
        # f32 in, (hi, lo) out; one TwoSum combine (10 f32 adds) an element
        (x,) = args
        return 12 * x.numel(), 10 * x.numel()
    if name == "slot_expand":
        # rows read: in each partition the union of the runs
        # [start, min(start + C, cap)), which overlap (C exceeds the fair
        # share); rows written: P*D*C
        words, offs, C = args   # [P, cap, W], [P, D]
        P, cap, W = words.shape
        real = 0
        for row in offs.long().clamp(0, cap).tolist():
            reach = 0
            for s in sorted(row):
                s, e = max(s, reach), min(s + C, cap)
                real += max(e - s, 0)
                reach = max(reach, e)
        return 4 * W * (real + offs.numel() * C) + 4 * offs.numel(), 0
    # every destination's out_rows written, its valid rows (at most
    # out_rows) read
    recv, counts, C, out_rows = args    # [Dd, S*C, W], [Dd, S]
    W = recv.shape[2]
    valid = int(counts.long().clamp(0, C).sum(1).clamp(max=out_rows).sum())
    return (4 * W * (valid + counts.shape[0] * out_rows)
            + 4 * counts.numel()), 0


def path_work(captured) -> dict:
    """Per kernel, over one run's captured calls: the calls, the bytes
    and operations ``work`` counts, and their bound in ms (each call's
    larger of bytes over the memory rate and operations over the peak
    rate, summed)."""
    out = {}
    for name, calls in captured.items():
        ws = [work(name, a) for _s, a in calls]
        out[name] = {
            "calls": len(ws), "bytes": sum(b for b, _o in ws),
            "ops": sum(o for _b, o in ws),
            "bound_ms": sum(max(b / PEAK_BYTES_PER_S, o / PEAK_OPS_PER_S)
                            for b, o in ws) * 1e3}
    return out


def per_launch_us(prof: dict, name: str):
    """A kernel's device µs per launch in a path's profile: the mean of
    its recorded device events (a profile may record fewer events than
    the run launched), or None where none was recorded."""
    ms = (prof.get("port_kernels_ms") or {}).get(name, 0.0)
    n = (prof.get("port_kernel_events") or {}).get(name, 0)
    return ms * 1e3 / n if n else None


def path_bound(pwork: dict, prof: dict) -> dict:
    """A path's bound per kernel (``path_work`` of a run with the
    profiled run's shapes) beside the profiled run's device time (its
    launches times the mean of its recorded events): the roofline share
    is bound / device time."""
    out = {}
    for name in TPU_KERNEL:
        w, n = pwork.get(name), prof["launches"].get(name, 0)
        us = per_launch_us(prof, name)
        if not w or not n or us is None:
            continue
        dev = us * n / 1e3
        out[name] = {**w, "profiled_launches": n,
                     "profiled_events": prof["port_kernel_events"][name],
                     "device_us_per_launch": us, "path_device_ms": dev,
                     "bound_share": w["bound_ms"] / dev}
    return out


def library_call(name: str, args):
    """PyTorch's library ops computing the same function, output for
    output (a yardstick only; the port never calls it), or None.
    ``hist_buckets``' is one ``bincount`` over p*(B+1) + id of all P
    rows (ids in [0, B] at the timed shape).  The slot kernels have no
    one-call counterpart: theirs is the gather index built from the
    offsets/counts, then one ``index_select`` (into the receive layout
    for ``slot_expand``; for ``slot_compact`` each destination's valid
    rows by ``nonzero``, ``index_copy_`` into a zeroed output), all
    inside the timed call.
    ``prefix_sum2``'s is the JAX fallback's x64 recipe: a float64 cumsum
    split into its f32 head and the f32 rounding of the rest."""
    import torch
    if name == "hist_buckets":
        bid, nb = args
        P = bid.shape[0]
        base = torch.arange(P, dtype=torch.int32,
                            device=bid.device)[:, None] * (nb + 1)
        return lambda: torch.bincount((bid + base).view(-1),
                                      minlength=P * (nb + 1)
                                      ).view(P, nb + 1)[:, :nb]
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
        P, cap, W = words.shape
        D = offs.shape[1]

        def expand():
            xp = torch.cat([words, words.new_zeros((P, C, W))], 1)
            start = offs.long().clamp(0, cap) + torch.arange(
                P, device=words.device)[:, None] * (cap + C)   # [P, D]
            src = (start.t()[:, :, None]
                   + torch.arange(C, device=words.device))   # [D, P, C]
            return xp.view(-1, W).index_select(0, src.reshape(-1)).view(
                D, P * C, W)
        return expand
    recv, counts, C, out_rows = args
    Dd, rows, W = recv.shape

    def compact():
        cnt = counts.long().clamp(0, C)                      # [Dd, S]
        idx = torch.arange(rows, device=recv.device)
        keep = (idx % C) < cnt[:, idx // C]                  # [Dd, S*C]
        rank = torch.cumsum(keep, 1) - 1
        keep &= rank < out_rows
        src = torch.nonzero(keep.view(-1)).squeeze(1)
        dst = (rank + torch.arange(Dd, device=recv.device)[:, None]
               * out_rows).view(-1)[src]
        out = recv.new_zeros((Dd * out_rows, W))
        out.index_copy_(0, dst, recv.view(-1, W).index_select(0, src))
        return out.view(Dd, out_rows, W)
    return compact


def profile_window(fn, calls: int = 20) -> list:
    """torch.profiler over ``calls`` calls of ``fn`` and nothing else:
    [(kernel or memset name, count, device µs in all)]."""
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
    return [(ev.key, ev.count, ev.self_device_time_total) for ev in avgs[0]
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not ev.key.startswith("ProfilerStep")]


def profile_calls(name: str, fn, calls: int = 20, tries: int = 3,
                  per_call: int = 1) -> dict:
    """The row's kernel time per call at the timed shape, and the device
    events (kernels and memsets) per call, in all and by name.  A window
    records only some of its events (16 of 20 on the H100 in PR 9's run
    Q), so the time per call is the mean of the kernel's recorded events
    times ``per_call``, the kernel's launches in one call of ``fn``.  A
    window that recorded none of the kernel's events is taken again, up
    to ``tries`` windows."""
    for _ in range(tries):
        ours = n_ours = events = 0
        by_name = {}
        for key, count, us in profile_window(fn, calls):
            events += count
            by_name[key[:80]] = count / calls
            if any(s in key for s in DEVICE_NAMES[name]):
                ours += us
                n_ours += count
        if ours:
            break
    if not ours:
        raise AssertionError(f"{name}: no profiled device time under "
                             f"{DEVICE_NAMES[name]} at the timed shape")
    return {"device_us_at_timed_shape": ours / n_ours * per_call,
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


def pack_side_kernels(prof) -> tuple:
    """(exchanges, {kernel: device µs}) over the exchange's pack-side
    profiler ranges (``PACK_RANGE``, one per exchange): the kernels the
    PyTorch ops inside one launched.  The profiler attaches no kernel
    launched through ctypes to the range: the port's own kernels there
    are counted from their whole-run totals instead (``pack_side``)."""
    import torch
    ranges = [ev for ev in prof.events() if ev.name == PACK_RANGE
              and ev.device_type == torch.autograd.DeviceType.CPU]
    by = collections.Counter()
    for r in ranges:
        todo = [r]
        while todo:
            ev = todo.pop()
            for k in ev.kernels:
                by[k.name] += k.duration
            todo.extend(ev.cpu_children)
    return len(ranges), by


def removed_copies_us(args) -> float:
    """Device µs of what this change removed from the pack side, replayed
    at a batched ``slot_expand`` call's shape: the P per-partition send
    buffers [D*C, W] stacked, then permuted to the receive layout with
    ``transpose(0, 1).contiguous()`` (parallel/shuffle.py before the
    batched kernels)."""
    import torch
    words, offs, C = args
    P, _cap, W = words.shape
    D = offs.shape[1]
    send = [torch.empty((D * C, W), dtype=torch.int32, device=words.device)
            for _ in range(P)]
    calls = 20
    return sum(us for _k, _c, us in profile_window(
        lambda: torch.stack(send).view(P, D, C, W).transpose(0, 1)
        .contiguous(), calls)) / calls


def pack_side(prof: dict, captured) -> dict:
    """The pack side of one exchange, from a path's profile, in device µs
    per exchange: hist_buckets and slot_expand (each launches once per
    exchange and nowhere else, so from its whole-run total), the copy
    kernels among the ops in the pack range, and all of the range's
    kernels by name; against the bound of hist_buckets' and
    slot_expand's bytes at this run's shapes.  Beside it, the copies of
    the send buffers that the batched slot_expand removed, replayed at
    this run's shape.  The exchange's one prefix_sum launch (P*P counts)
    is not in the figures."""
    n, by = prof.get("pack_exchanges", 0), prof.get("pack_kernels_us")
    if not n or not by:
        raise AssertionError(f"no device time in the {PACK_RANGE} ranges "
                             f"({n} ranges)")
    for name in PACK:
        if prof["launches"][name] != n:
            raise AssertionError(f"{name}: {prof['launches'][name]} "
                                 f"launches for {n} exchanges")
    hist = prof["port_kernels_ms"]["hist_buckets"] * 1e3 / n
    expand = prof["port_kernels_ms"]["slot_expand"] * 1e3 / n
    copies = sum(us for k, us in by.items()
                 if any(s in k for s in ("copy", "Copy", "CatArray",
                                         "Memcpy"))) / n
    bound = 0.0
    for name in PACK:
        calls = captured[name]
        bound += sum(max(b / PEAK_BYTES_PER_S, o / PEAK_OPS_PER_S)
                     for b, o in (work(name, a) for _s, a in calls)
                     ) / len(calls) * 1e6
    _s, ex_args = max(captured["slot_expand"], key=lambda c: c[0])
    return {
        "exchanges": n, "hist_us": hist, "expand_us": expand,
        "copy_kernels_us": copies,
        "hist_expand_copies_us": hist + expand + copies,
        "hist_plus_expand_bound_us": bound,
        "pack_device_us": hist + expand + sum(by.values()) / n,
        "range_kernels_us": {k[:100]: us / n
                             for k, us in by.most_common(12)},
        "removed_send_copies_us_replayed": removed_copies_us(ex_args),
        "expand_shape": [list(a.shape) if hasattr(a, "shape") else a
                         for a in ex_args],
    }


def profile_path(run, label, out_dir, tries: int = 3,
                 pack: bool = True) -> dict:
    """``profile_run``, taken again (up to ``tries`` times) while a port
    kernel launched in the run shows no profiled device time or (with
    ``pack``) the pack ranges show none: the profiler can miss a window's
    events.  Fails when the last take still misses a launched kernel."""
    for attempt in range(tries):
        prof = profile_run(run, label, out_dir, pack)
        ours = prof.get("port_kernels_ms") or {}
        missing = [k for k, n in prof["launches"].items()
                   if n and not ours.get(k)]
        if not missing and (not pack or prof.get("pack_kernels_us")):
            break
    if missing:
        raise AssertionError(
            f"{label}: {missing} launched but show no profiled device "
            f"time in {tries} profiles")
    return {**prof, "profile_takes": attempt + 1}


def _no_pack(prof: dict) -> dict:
    """A path's profile without its raw pack-side events."""
    return {k: v for k, v in prof.items() if not k.startswith("pack_")}


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
        wrapper, plain = fns(hk, name)
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
        prof_per_launch = per_launch_us(prof, name)
        if prof_launches and not prof_ms:
            raise AssertionError(
                f"{name}: {prof_launches} launches in the profiled {label} "
                f"run but no profiled device time: DEVICE_NAMES misses its "
                f"kernels")
        nbytes, ops = work(name, args)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S * 1e3
        loop = {}
        if name == "slot_compact":
            # the same exchange's unpack as Dd one-destination calls
            recv, counts, C, out_rows = args

            def each():
                for d in range(recv.shape[0]):
                    hk.slot_compact(recv[d], counts[d], C, out_rows)
            loop = {"loop_ms": cuda_ms(each),
                    "loop_device_us_per_exchange": profile_calls(
                        name, each, per_call=recv.shape[0]
                    )["device_us_at_timed_shape"],
                    "loop_host_enqueue_us": host_enqueue_us(each)}
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
                prof_per_launch / 1e3 if prof_per_launch else None),
            # the same at the timed shape alone, and the host's side
            **profile_calls(name, lambda: wrapper(*args)),
            "host_enqueue_us": host_enqueue_us(lambda: wrapper(*args)),
            **loop,
            "timed_on": label,
            "shape": [list(a.shape) if hasattr(a, "shape") else a
                      for a in args],
            "bytes": nbytes,
            "card": card,
        })
    return rows


def profile_run(run, label, out_dir, pack: bool = True) -> dict:
    """Device time by kernel over one warm run of a path (kernel-level
    events only: the operator-level rows repeat their kernels' time).
    ``run()`` returns (table, launches, load_s, query_s).  ``pack``
    also traces the host side, which the pack-side ranges need; without
    it only the device is traced (PageRank's warm run issues hundreds of
    thousands of host ops, whose events the profiler is slow to
    process)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    if pack:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        _out, launches, load, query = run()
    wall = load + query
    avgs = prof.key_averages()
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
        f.write(avgs.table(sort_by="self_cuda_time_total", row_limit=60))
    dev_ms, dev_n = collections.Counter(), collections.Counter()
    for ev in avgs:
        # the pack range shows on the device timeline too, as a span
        # over its kernels: not device time of its own
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.key != PACK_RANGE):
            dev_ms[ev.key] += ev.self_device_time_total / 1e3
            dev_n[ev.key] += ev.count
    if not dev_ms:
        return {"device_ms": None, "wall_s": wall, "load_s": load,
                "query_s": query, "launches": launches}
    pack_n, pack_by = pack_side_kernels(prof) if pack else (0, {})
    ours = {k: sum(v for key, v in dev_ms.items()
                   if any(s in key for s in subs))
            for k, subs in DEVICE_NAMES.items()}
    events = {k: sum(n for key, n in dev_n.items()
                     if any(s in key for s in subs))
              for k, subs in DEVICE_NAMES.items()}
    total = sum(dev_ms.values())
    return {"wall_s": wall, "load_s": load, "query_s": query,
            "launches": launches, "device_ms": total,
            "device_busy_share": total / 1e3 / wall,
            "port_kernels_ms": ours,
            # recorded device events per kernel: a profile may record
            # fewer than the launches
            "port_kernel_events": events,
            "rest_ms": total - sum(ours.values()),
            "pack_exchanges": pack_n, "pack_kernels_us": pack_by,
            "top": [[k[:120], v] for k, v in dev_ms.most_common(12)]}


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lines", type=int, default=1_000_000)
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--records", type=int, default=1_000_000)
    ap.add_argument("--nodes", type=int, default=100_000,
                    help="PageRank nodes; edges are 10x the nodes")
    ap.add_argument("--points", type=int, default=500_000,
                    help="k-means points (dim 8, k = 16, 5 iterations)")
    ap.add_argument("--lineitems", type=int, default=6_000_000,
                    help="phase 9's lineitems; orders a quarter, "
                    "customers a fortieth (TPC-H SF1: 6,000,000)")
    ap.add_argument("--orders", type=int, default=1_500_000,
                    help="phase 10's orders, each with 1 to 7 nested "
                    "lineitems (TPC-H SF1: 1,500,000)")
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
    lines_path = os.path.join(a.out, "chip_smoke.jsonl")
    open(lines_path, "w").close()

    started = time.perf_counter()

    def emit(obj) -> None:
        """A result line on stdout and in ``--out``/chip_smoke.jsonl
        (the whole run's lines outlast a cut-off stdout), with the
        seconds since the script started (``t_s``; not on the kernels
        line, whose keys are fixed)."""
        if list(obj) != ["kernels"]:
            obj = {**obj, "t_s": time.perf_counter() - started}
        line = json.dumps(obj)
        print(line, flush=True)
        with open(lines_path, "a") as f:
            f.write(line + "\n")

    port = import_port()
    from dryad_tpu_torch.apps import groupbyreduce as gbr
    from dryad_tpu_torch.apps import kmeans as km
    from dryad_tpu_torch.apps import pagerank as pr
    from dryad_tpu_torch.apps import terasort as ts
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
    emit({"phase": "build", "seconds": build_s,
                      "kernels": sorted(logs), "card": card})

    check_kernels(hk, dev)
    emit({"phase": "kernels", "ok": True, "card": card})

    # every main-path run: label -> (launches, {kernel: max |kernel -
    # plain|} over all its calls); the TIMED_ON runs keep their calls
    runs, timed_calls = {}, {}

    def held(label, launches, captured):
        runs[label] = (launches, hold_run(hk, label, captured))
        if label in PROFILED:
            timed_calls[label] = captured

    corpora = {"bench12": bench_corpus(a.lines),
               "zipf50k": zipf_corpus(a.lines)}
    for cname, lines in corpora.items():
        want = oracle(lines)
        hk.capture = {}
        out, launches, load, query, logs = run_wordcount(port, hk, wc,
                                                         lines)
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
        stages = exchanging_stages(logs)
        check_per_exchange(cname, launches, exchange_attempts(stages),
                           probes=probes_run(stages))
        _, _, wload, wquery, _ = run_wordcount(port, hk, wc, lines)
        warm = wload + wquery
        emit({
            "corpus": cname, "lines": len(lines), "nparts": NPARTS,
            "words": len(want), "tokens": sum(want.values()),
            "launches": launches, "exchanging_stages": stages,
            "cold_wall_s": load + query,
            "warm_wall_s": warm, "warm_load_s": wload,
            "warm_query_s": wquery, "lines_per_s": len(lines) / warm,
            "card": card})

    variants = gbr_variants(port, gbr)
    for vname, (n_keys, query, cols) in variants.items():
        data = gbr.gen_pairs(a.rows, n_keys, seed=0)
        hk.capture = {}
        out, launches, load, qs, logs = run_gbr(port, hk, data, query)
        captured, hk.capture = hk.capture, None
        check_gbr(vname, out, data, cols)
        held(vname, launches, captured)
        zero = [k for k in (TPU_KERNEL if vname == "app10k" else EXCHANGE)
                if launches[k] == 0]
        if zero:
            raise AssertionError(f"{vname}: kernels never launched: {zero}")
        stages = exchanging_stages(logs)
        check_per_exchange(vname, launches, exchange_attempts(stages),
                           probes=probes_run(stages))
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
        _, _, wload, wquery, _ = run_gbr(port, hk, data, query)
        warm = wload + wquery
        emit({
            "groupbyreduce": vname, "rows": a.rows, "keys": n_keys,
            "groups": len(out["k"]), "nparts": NPARTS,
            "launches": launches, "exchanging_stages": stages,
            "cold_wall_s": load + qs,
            "warm_wall_s": warm, "warm_load_s": wload,
            "warm_query_s": wquery, "rows_per_s": a.rows / warm,
            "card": card})

    sorts = sort_runs(ts, gbr, a.records, a.rows)
    for sname, ((data, sml), queries, check) in sorts.items():
        hk.capture = {}
        outs, launches, load, qs, logs = run_sort(port, hk, data, sml,
                                                  queries)
        captured, hk.capture = hk.capture, None
        sizes = check(outs, data)
        del outs
        held(sname, launches, captured)
        zero = [k for k in EXCHANGE if launches[k] == 0]
        if zero:
            raise AssertionError(f"{sname}: kernels never launched: {zero}")
        stages = exchanging_stages(logs)
        check_per_exchange(sname, launches, exchange_attempts(stages),
                           probes=probes_run(stages))
        _, _, wload, wquery, wlogs = run_sort(port, hk, data, sml, queries)
        warm = wload + wquery
        emit({
            "sort": sname, **sizes, "nparts": NPARTS,
            "exchanging_stages": stages,
            "warm_exchanging_stages": exchanging_stages(wlogs),
            "launches": launches, "cold_wall_s": load + qs,
            "warm_wall_s": warm, "warm_load_s": wload,
            "warm_query_s": wquery, "rows_per_s": sizes["rows"] / warm,
            "card": card})
    tera_data, tera_sml = sorts["terasort1m"][0]
    del sorts

    n_edges = PR_EDGES * a.nodes // 100_000
    edges = pr.gen_graph(a.nodes, n_edges, seed=0)
    hk.capture = {}
    out, launches, load, qs, pr_runs = run_pagerank(port, hk, pr, edges,
                                                    a.nodes)
    captured, hk.capture = hk.capture, None
    sizes = check_pagerank(out, edges, a.nodes, pr)
    del out
    held("pagerank100k", launches, captured)
    # a fresh context: the warm, profiled run makes these calls again
    pr_work = path_work(captured)
    del captured
    zero = [k for k in TPU_KERNEL if launches[k] == 0]
    if zero:
        raise AssertionError(f"pagerank100k: kernels never launched: {zero}")
    stages = loop_stages(pr_runs)
    check_per_exchange("pagerank100k", launches, stages["exchange_attempts"],
                       probes=stages["probes"])
    check_feedback("pagerank100k", stages)
    _, _, wload, wquery, wruns = run_pagerank(port, hk, pr, edges, a.nodes)
    steps = [r["s"] for r in wruns if r["superstep"]]
    emit({
        "pagerank": "pagerank100k", **sizes, "edges": n_edges,
        "edges_with_ring": len(edges["src"]), "iters": PR_ITERS,
        "nparts": NPARTS, "launches": launches, "stages": stages,
        "warm_stages": loop_stages(wruns),
        "cold_wall_s": load + qs, "cold_load_s": load, "cold_query_s": qs,
        "warm_wall_s": wload + wquery, "warm_load_s": wload,
        "warm_query_s": wquery, "warm_superstep_s": steps,
        "warm_superstep_mean_s": sum(steps) / len(steps),
        "edges_per_s_iter": n_edges * PR_ITERS / wquery,
        "executor_run_s": sum(r["s"] for r in wruns),
        "edges_per_sec_iter_chip_run": n_edges * PR_ITERS / sum(
            r["s"] for r in wruns),
        "card": card})
    emit({"nan_minmax": check_nan_minmax(port), "ok": True, "card": card})

    km_pts, _ = km.gen_points(a.points, KM_DIM, KM_K, seed=0)
    hk.capture = {}
    cents, launches, load, qs, km_runs = run_kmeans(port, hk, km, km_pts)
    captured, hk.capture = hk.capture, None
    sizes = check_kmeans(cents, km_pts, km)
    held("kmeans500k", launches, captured)
    del captured
    zero = [k for k in EXCHANGE if launches[k] == 0]
    if zero:
        raise AssertionError(f"kmeans500k: kernels never launched: {zero}")
    stages = loop_stages(km_runs)
    check_per_exchange("kmeans500k", launches, stages["exchange_attempts"],
                       stages["broadcast_attempts"], stages["probes"])
    check_feedback("kmeans500k", stages)
    _, _, wload, wquery, wruns = run_kmeans(port, hk, km, km_pts)
    steps = [r["s"] for r in wruns if r["superstep"]]
    emit({
        "kmeans": "kmeans500k", **sizes, "nparts": NPARTS,
        "launches": launches, "stages": stages,
        "warm_stages": loop_stages(wruns),
        "cold_wall_s": load + qs, "cold_load_s": load, "cold_query_s": qs,
        "warm_wall_s": wload + wquery, "warm_load_s": wload,
        "warm_query_s": wquery, "warm_iteration_s": steps,
        "warm_iteration_mean_s": sum(steps) / len(steps),
        "points_per_s_iter": a.points * KM_ITERS / wquery,
        "card": card})

    # the set operators, the broadcast join and the scalars: each one
    # main-path run, its kernel calls held, its launches checked against
    # the executor's log
    left, right = setop_tables(a.rows // 2)
    bleft, bright = bcast_tables(gbr, a.rows)
    nan_data = nan_minmax_data()
    phase8 = {
        "setops1m": (lambda ctx: setop_queries(ctx, left, right),
                     lambda out: check_setops(out, left, right), EXCHANGE),
        "bcastjoin2m": (lambda ctx: bcast_join(ctx, bleft, bright),
                        lambda out: check_bcast_join(out, run_app(
                            port, hk, lambda c: bcast_join(
                                c, bleft, bright, broadcast=False))[0],
                            bleft), ("slot_compact",)),
        "scalars2m": (lambda ctx: scalar_queries(port, ctx, gbr_data,
                                                 nan_data),
                      lambda out: check_scalars(out, gbr_data, nan_data),
                      EXCHANGE),
    }
    for label, (app, check, must) in phase8.items():
        hk.capture = {}
        out, launches, load, qs, app_runs = run_app(port, hk, app)
        captured, hk.capture = hk.capture, None
        held(label, launches, captured)
        del captured
        zero = [k for k in must if launches[k] == 0]
        if zero:
            raise AssertionError(f"{label}: kernels never launched: {zero}")
        stages = loop_stages(app_runs)
        check_per_exchange(label, launches, stages["exchange_attempts"],
                           stages["broadcast_attempts"], stages["probes"])
        sizes = check(out)
        del out
        emit({"phase8": label, **sizes, "nparts": NPARTS,
              "launches": launches,
              "exchanging_stages": stages["outside_loop"],
              "exchange_attempts": stages["exchange_attempts"],
              "broadcast_attempts": stages["broadcast_attempts"],
              "probe_launches": stages["probes"],
              "load_s": load, "query_s": qs, "card": card})

    # phase 9: each run cold (its calls held, its launches checked against
    # the executor's log), warm, and warm under the profiler (busy share)
    for label, (app, check, rows, must) in phase9_runs(
            *tpch_tables(a.lineitems)).items():
        hk.capture = {}
        out, launches, load, qs, app_runs = run_app(port, hk, app)
        captured, hk.capture = hk.capture, None
        held(label, launches, captured)
        del captured
        zero = [k for k in must if launches[k] == 0]
        if zero:
            raise AssertionError(f"{label}: kernels never launched: {zero}")
        stages = loop_stages(app_runs)
        check_per_exchange(label, launches, stages["exchange_attempts"],
                           stages["broadcast_attempts"], stages["probes"])
        sizes = check(out, app_runs)
        del out
        _, _, wload, wquery, wruns = run_app(port, hk, app)
        prof = profile_path(lambda: run_app(port, hk, app)[:4], label,
                            a.out, pack=False)
        emit({"phase9": label, **sizes, "nparts": NPARTS,
              "launches": launches,
              "exchanging_stages": stages["outside_loop"],
              "warm_exchanging_stages": loop_stages(wruns)["outside_loop"],
              "exchange_attempts": stages["exchange_attempts"],
              "broadcast_attempts": stages["broadcast_attempts"],
              "probe_launches": stages["probes"],
              "cold_wall_s": load + qs, "cold_load_s": load,
              "cold_query_s": qs, "warm_wall_s": wload + wquery,
              "warm_load_s": wload, "warm_query_s": wquery,
              "rows_per_s": rows / (wload + wquery),
              "profiled_wall_s": prof["wall_s"],
              "profiled_device_ms": prof["device_ms"],
              "device_busy_share": prof.get("device_busy_share"),
              "port_kernels_ms": prof.get("port_kernels_ms"),
              "top": prof.get("top"), "card": card})

    # phase 10: each run cold (its calls held, its launches checked
    # against the executor's log, slot probes apart), then warm and warm
    # under the profiler in the cold run's context (measured slots from
    # the slot feedback); a vmap fallback to a Python loop over groups is
    # an error
    orders = nested_orders(a.orders)
    li_np = flat_lineitems(orders)
    ten = {}
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=VMAP_FALLBACK)
        torch._C._functorch._set_vmap_fallback_warning_enabled(True)
        for label, (app, warm_app, check, must) in phase10_runs(
                orders, li_np).items():
            ctx = port.Context(device="cuda", nparts=NPARTS)
            hk.capture = {}
            out, launches, load, qs, app_runs = run_app(port, hk, app,
                                                        ctx=ctx)
            captured, hk.capture = hk.capture, None
            held(label, launches, captured)
            del captured
            zero = [k for k in must if launches[k] == 0]
            if zero:
                raise AssertionError(f"{label}: kernels never launched: "
                                     f"{zero}")
            stages = loop_stages(app_runs)
            check_per_exchange(label, launches, stages["exchange_attempts"],
                               stages["broadcast_attempts"],
                               stages["probes"])
            sizes = check(out, app_runs, False)
            del out
            line = {"phase10": label, **sizes, "nparts": NPARTS,
                    "lineitems": len(li_np["okey"]), "launches": launches,
                    "probe_launches": stages["probes"],
                    "exchanging_stages": stages["outside_loop"],
                    "exchange_attempts": stages["exchange_attempts"],
                    "cold_wall_s": load + qs, "cold_load_s": load,
                    "cold_query_s": qs, "card": card}
            if warm_app is not None:
                if label == "unnest6m":
                    # the warm run's calls: the profiled run's shapes (its
                    # slots come from the feedback, the cold run's not)
                    hk.capture = {}
                wout, wlaunches, wload, wquery, wruns = run_app(
                    port, hk, warm_app, ctx=ctx)
                if hk.capture is not None:
                    un_work, hk.capture = path_work(hk.capture), None
                wsizes = check(wout, wruns, True)
                del wout
                prof = profile_path(lambda: run_app(
                    port, hk, warm_app, ctx=ctx)[:4], label, a.out,
                    pack=False)
                if label == "unnest6m":
                    un_prof = prof
                pl = prof["launches"]
                line.update({
                    "warm": wsizes, "warm_launches": wlaunches,
                    "warm_exchanging_stages":
                        loop_stages(wruns)["outside_loop"],
                    "warm_wall_s": wload + wquery, "warm_load_s": wload,
                    "warm_query_s": wquery,
                    "rows_per_s": len(li_np["okey"]) / (wload + wquery),
                    "profiled_wall_s": prof["wall_s"],
                    "profiled_device_ms": prof["device_ms"],
                    "device_busy_share": prof.get("device_busy_share"),
                    "port_kernels_ms": prof.get("port_kernels_ms"),
                    # device µs per launch at the measured slots
                    "device_us_per_launch": {
                        k: per_launch_us(prof, k) for k in TPU_KERNEL
                        if pl.get(k)},
                    "top": prof.get("top")})
                ten[label] = wquery
            emit(line)
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    emit({"phase10": "claim_saving", "card": card,
          "warm_query_s_shuffled_less_claimed":
              ten["unnest6m_shuffled"] - ten["unnest6m"]})
    del orders, li_np

    wc_prof = profile_path(
        lambda: run_wordcount(port, hk, wc, corpora["zipf50k"])[:4],
        "wordcount_zipf50k", a.out)
    emit({"profile": "wordcount zipf50k warm run",
                      **_no_pack(wc_prof), "card": card})
    gbr_prof = profile_path(
        lambda: run_gbr(port, hk, gbr_data, variants["app10k"][1])[:4],
        "groupbyreduce_app10k", a.out)
    emit({"profile": "groupbyreduce app10k warm run",
                      **_no_pack(gbr_prof), "card": card})
    tera_prof = profile_path(
        lambda: run_sort(port, hk, tera_data, tera_sml,
                         [ts.terasort_query])[:4],
        "terasort1m", a.out)
    emit({"profile": "terasort1m warm run",
                      **_no_pack(tera_prof), "card": card})
    pr_prof = profile_path(
        lambda: run_pagerank(port, hk, pr, edges, a.nodes)[:4],
        "pagerank100k", a.out, pack=False)
    emit({"profile": "pagerank100k warm run", **_no_pack(pr_prof),
          "card": card})
    km_prof = profile_path(
        lambda: run_kmeans(port, hk, km, km_pts)[:4], "kmeans500k", a.out,
        pack=False)
    emit({"profile": "kmeans500k warm run", **_no_pack(km_prof),
          "card": card})
    for label, prof in (("zipf50k", wc_prof), ("app10k", gbr_prof),
                        ("terasort1m", tera_prof)):
        emit({"pack_side": label,
                          **pack_side(prof, timed_calls[label]),
                          "card": card})
    for label, pwork, prof in (
            ("zipf50k", path_work(timed_calls["zipf50k"]), wc_prof),
            ("app10k", path_work(timed_calls["app10k"]), gbr_prof),
            ("pagerank100k", pr_work, pr_prof),
            ("unnest6m", un_work, un_prof)):
        emit({"path_bound": label, "kernels": path_bound(pwork, prof),
              "card": card})
    emit({"phase": "held", "ok": True, "runs": {
        r: {k: {"launches": l[k], "max_abs_err": e[k]} for k in e}
        for r, (l, e) in runs.items()}, "card": card})
    rows = time_kernels(hk, runs, {
        "zipf50k": (timed_calls["zipf50k"], wc_prof),
        "app10k": (timed_calls["app10k"], gbr_prof)}, card)
    for row in rows:
        emit({"kernel": row})
    print(card)
    emit({"kernels": rows})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
