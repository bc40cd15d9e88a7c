#!/usr/bin/env python3
"""Drive the PyTorch port (dryad_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--lines N] [--rows N] [--records N] [--nodes N]
                          [--points N] [--lineitems N] [--orders N]
                          [--stream-scale F] [--out DIR]

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
 11. recovery and storage through the same entry points: pagerank100k
     in the deferred (default) and the synchronous form
     (``JobConfig(deferred_needs=False)``), each warm: ranks bit-identical
     between them and within rtol 2e-3 of ``pagerank_numpy``, launches
     equal, and per form the host syncs of a run (``torch.cuda.
     set_sync_debug_mode("warn")``, by Python call site), its NEED reads
     (``Executor.host_reads``: one per executor run when deferred), warm
     wall and busy share; terasort1m and skewjoin6m with an event log,
     exactly numpy's, the ``settle_replay`` events naming exactly the
     stages the log flags ``settle_replayed``, launches equal to the
     executor's exchange attempts with the replays, and
     ``max_capacity_retries=0`` raising CapacityError at the settle; a
     ``Run`` over skewjoin6m's plan with every stage invalidated giving
     the same rows bit for bit (one ``stage_replay`` each) and
     ``failure_budget=2`` raising at the third invalidation; a TPC-H
     Q1-shaped fork over the 6,000,000 lineitems with ``spill_dir``
     (every stage spilled; a fresh executor restores the output with no
     stage recomputed; ``invalidate(out, drop_spill=True)`` recomputes
     only it; write and read GB/s and the checksum's time); the lineitem
     table through ``to_store`` / ``from_store``, the orders
     hash-partitioned and reloaded with their claim, the orders with
     gzip, a flipped byte raising StoreIntegrityError; ``read_text`` of
     the bench12 corpus written to a file, WordCount equal to phase 3's
     counts.  Stores live in a temporary directory, deleted after;
 12. adaptive execution, the static cost model and the oracle through
     the same entry points.  Three cells, each in two contexts of its
     own, ``JobConfig(adaptive="off")`` and ``"on"``, with an event log:
     ``adaptshrink6m`` (bench.py's ``smoke_adapt`` shape at 6,000,000
     rows: 90 % on key 0, group_by sum -> with_capacity(131,072) ->
     order_by s descending; on must record ``repartition_shrink``),
     ``q17promote6m`` (TPC-H Q17's shape: 6,000,000 lineitems' quantity
     sum and count per part joined with the ~200 parts of one brand and
     container of a 200,000-row PART; ``broadcast_promote``) and
     ``demote1m`` (1,500,000 orders per customer joined with
     ``broadcast=True`` to 150,000 customers' largest balance;
     ``broadcast_demote``).  Each: a cold run per mode (off first, its
     runs given ``analysis.cost.estimate_graph``'s report), its calls
     held and its launches against the executor's log; rows equal
     between the modes and numpy's (f32 sums within 16 eps sum|v|); three
     warm runs per mode in turns, NEED reads per run, one profiled warm
     run per mode (busy share), the order_by stage's output bytes.  The
     cost model on the card: zipf50k, app10k, terasort1m, pagerank100k
     and kmeans500k once each with every executor run cost-checked, plus
     the three cells' off runs: any ``cost_model_miss`` is printed and
     fails the phase, and an estimate that launches a port kernel or
     allocates on the card fails it too.  The oracle: the three cells at
     20,000 rows and WordCount over bench12's first 2,000 lines, on the
     card and through ``Context(device="cuda", local_debug=True)``,
     equal as row multisets (f32 within the bound);
 13. out-of-core streaming through the streamed entry points
     (``read_store_stream``, ``read_text_stream``, ``cache()``,
     ``terasort_ooc``; inputs written under ``--out``, deleted after;
     ``--stream-scale F`` scales its data, the chunks stay):
     ``terasortooc10m`` (10,000,000 TeraGen records written chunk
     by chunk to a store, ``order_by(key).to_store`` in 262,144-row
     chunks, read back: the count, keys non-decreasing as bytes, the
     (key, payload) multiset; ``ooc_inflight`` 1 once, 2 cold, warm and
     profiled, the in-core tier once, the depth-2 query at 1,000,000
     records (the big warm run's peak device memory above its start
     must be at most 1.5 times this run's), and the ``terasort_ooc``
     app at 2,000,000; ``hist_buckets`` once per chunk scattered, the
     in-core tier none), ``pagerankstream100k`` (phase 7's graph from a store,
     ``pagerank_stream`` over its ``cache()``: ranks within rtol 2e-3,
     two cache writes cold, at least two hits a superstep),
     ``kmeansstream500k`` (phase 8's points from a store,
     ``kmeans_stream``: within 1e-3), ``q13stream1m5_right`` /
     ``_full`` (the SF1 orders streamed, right / full joined with the
     150,000 customers, orders per customer exactly numpy's, the 50,000
     without an order present) and ``readtextstream1m`` (the bench12
     corpus from a file, WordCount equal to phase 3's counts).  Each
     cold (held, host syncs counted), warm (wall, rows/s, chunks and
     bytes copied each way, prefetch stalls, peak device memory) and
     profiled warm (busy share); no exchange kernel launches; then the
     scatter's histogram at its shapes against ``bincount`` and its
     bound (``scatter_hist``);
  14. the SQL front end (``sql.query(ctx, catalog, text).collect()``,
     ``JobConfig(lint="warn")``) over phase 9's SF1 lineitems with
     ``price`` float32 and a ``tag`` string column, registered in a
     ``sql.Catalog``: ``sqlq3_6m`` adaptive off and on (bench.py's
     skewed join + filter + per-order revenue, ORDER BY revenue DESC
     LIMIT 10; cold each, then three warm runs of each in turns),
     ``sqlgolden_join6m`` / ``sqlgolden_scan6m`` (the committed
     ``docs/plans/*.sql``; the second filters ``tag != 'void'`` on the
     device) and ``sqlq1agg6m`` (GROUP BY qty with COUNT, SUM, AVG, MIN,
     MAX).  Rows against numpy (top-k with ties: each key's revenue
     within the f32 bound, the smallest at least the k-th less it); each
     cold run has no error-severity ``lint_finding``, one
     ``cost_report``, no ``cost_model_miss`` and one ``plan`` event that
     round-trips through ``graph_from_json``; EXPLAIN COST launches no
     kernel and predicts the run's capacities.  All five kernels must
     launch in the phase;
  15. observability, over phase 14's catalog and phase 7's graph:
     ``obs_sqlq3_6m`` (``sql.explain(ctx, catalog, "EXPLAIN ANALYZE " +
     SQL_Q3)``, adaptive off: the report's settled stages' rows equal to
     the rows the run's ``stage_done`` events carry, every scale-1 stage
     inside its predicted rows and, where no stage upstream of it was
     rescaled, its predicted bytes, zero ``cost_model_miss``, the join's
     unsalted retry: 2 runs); ``obs_pagerank100k`` (PageRank three times
     with telemetry off, no event log, and three times on,
     ``EventLog(level=2, history_dir=..., app="pagerank")`` with
     ``JobConfig(resource_sample_s=0.1)``, in turns: ranks bit-equal
     across all six and within rtol 2e-3 of ``pagerank_numpy``,
     ``Executor.host_reads`` equal on and off, per executor run one
     ``run`` job span, a ``stage`` span for each stage computed under
     it and one ``job_done`` with its trace id and metrics, resource
     samples with ``0 < device_bytes <= max_memory_allocated()``, the
     critical path of each run equal to its job span's wall, three
     history archives with events / plan / metrics / summary, ``python
     -m dryad_tpu_torch.obs`` trace / critical-path / metrics / analyze
     / history exiting 0 on the last archive, no thread left behind;
     warm-wall medians on and off); ``obs_profile_pagerank100k`` (one
     more run with ``JobConfig(profile_dir=...)``: one Chrome trace per
     executor run, whose kernel events name every port kernel the run
     launched with nonzero device time; its wall beside the unprofiled
     median).  The history archives stay under ``--out``/phase15, the
     traces are deleted once read.  All five kernels must launch;
 3-15. after each of those main-path runs, every kernel call it made
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
their source per attempt among them), one for phase 11 (``{"phase":
"recovery", ...}``), one per phase-12 cell and one each for its cost
model and oracle runs (``{"phase12": ...}``), one per phase-13 cell and
its scatter line (``{"phase13": ...}``), one per phase-14 cell
(``{"phase14": ...}``) and the phase's launches, one per phase-15 cell
(``{"phase15": ...}``) and the phase's launches, per profile, per pack
side
and per kernel, then
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
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
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
    10's orders repartition, phase 12's promoted broadcast with empty and
    one-row sources); then 50 calls of mixed sizes queued on one
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
    # phase 12's promoted broadcast: a build side of about 200 rows over
    # 8 sources of C = 25,000 rows (2 words) into 256 rows, with empty
    # and one-row sources
    recv = recv_of(1, 8, 25_000, 2)
    for cnt in ([0, 1, 0, 23, 1, 24, 22, 25], [1] * 8, [0] * 8):
        c = t(np.asarray([cnt], np.int32))
        same(call(recv, c, 25_000, 256),
             hk.slot_compact_batched_plain(recv, c, 25_000, 256),
             f"promoted broadcast counts={cnt}")
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

    def logged_run(graph, bindings=None, **kw):
        t0 = time.perf_counter()
        out = run(graph, bindings, **kw)
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
    g = skew_join_groups(ctx, li, orders, by).cache()
    return {"groups": g.collect(),
            "top": g.order_by([("revenue", True), (by, False)]).take(
                10).collect()}


def skew_join_groups(ctx, li, orders, by: str):
    """``skew_join_query``'s revenue and count per ``by`` key, before
    the cache."""
    j = ctx.from_columns(li).join(ctx.from_columns(orders), ["okey"]).where(
        lambda c: c["flag"] == 0).select(
        lambda c: {by: c[by], "rev": c["price"] * c["qty"]})
    return j.group_by([by], {"revenue": ("sum", "rev"),
                             "n": ("count", None)})


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
# phase 11: recovery and storage


SYNC_WARNING = "synchronizing CUDA operation"   # set_sync_debug_mode's text


def counted_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: (its
    result, the synchronizing CUDA calls it made, {the Python caller
    file:line: count}, the sites most common first)."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
        for w in caught if SYNC_WARNING in str(w.message))
    return out, sum(sites.values()), sites.most_common()


def pagerank_forms(port, hk, pr, edges, n_nodes, out_dir, held) -> dict:
    """pagerank100k in both forms, each in a context of its own: a cold
    run, a warm run (its kernel calls held, its launches counted), a warm
    run counting host syncs (``counted_syncs``) and NEED reads
    (``Executor.host_reads``), and a warm run under the profiler (busy
    share); then four timed warm runs in turns (deferred, sync, sync,
    deferred), each form's wall their mean.  The ranks must be
    bit-identical between the forms, every
    rank within PR_RTOL of ``pagerank_numpy``, and the launches equal
    but for the exchanges of the stages that the deferred settle re-ran
    because a stage before them overflowed (``settle_extra``): stage by
    stage the deferred form runs exactly one attempt more there and the
    same attempts elsewhere."""
    import torch
    forms, ranks, launched, entries, probes, ctxs = {}, {}, {}, {}, {}, {}

    def app(c):
        return pr.pagerank(c, edges, n_nodes, n_iters=PR_ITERS)

    for form, cfg in (("deferred", port.JobConfig()),
                      ("sync", port.JobConfig(deferred_needs=False))):
        ctx = ctxs[form] = port.Context(device="cuda", nparts=NPARTS,
                                        config=cfg)
        app(ctx)
        hk.capture = {}
        reads0 = ctx.executor.host_reads
        out, launches, load, qs, runs = run_app(port, hk, app, ctx=ctx)
        reads = ctx.executor.host_reads - reads0
        captured, hk.capture = hk.capture, None
        held(f"pagerank100k_{form}", launches, captured)
        del captured
        stages = loop_stages(runs)
        check_per_exchange(f"pagerank100k_{form}", launches,
                           stages["exchange_attempts"],
                           probes=stages["probes"])
        sizes = check_pagerank(out, edges, n_nodes, pr)
        o = np.argsort(out["node"])
        ranks[form] = np.asarray(out["rank"])[o]
        launched[form] = launches
        probes[form] = stages["probes"]
        entries[form] = [st for r in runs for st in r["stages"]]
        # one read per executor run and replayed attempt when deferred,
        # one per attempt when not
        want = (len(runs) + sum(st["attempts"] - 1 for st in entries[form]
                                if st["settle_replayed"])
                if form == "deferred" else
                sum(st["attempts"] for st in entries[form]))
        if reads != want:
            raise AssertionError(f"pagerank100k {form}: {reads} NEED reads, "
                                 f"not {want}")
        reads0 = ctx.executor.host_reads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, syncs, sites = counted_syncs(lambda: app(ctx))
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t0
        counted_reads = ctx.executor.host_reads - reads0
        prof = profile_path(lambda: run_app(port, hk, app, ctx=ctx)[:4],
                            f"pagerank100k_{form}", out_dir, pack=False)
        forms[form] = {
            "host_syncs_per_run": syncs, "sync_sites": sites,
            "need_reads_per_run": reads,
            "need_reads_counted_run": counted_reads,
            "executor_runs": len(runs),
            "stage_attempts": sum(st["attempts"] for r in runs
                                  for st in r["stages"]),
            "warm_wall_s": load + qs, "warm_load_s": load,
            "warm_query_s": qs, "counted_run_s": counted_s,
            "profiled_wall_s": prof["wall_s"],
            "profiled_device_ms": prof["device_ms"],
            "device_busy_share": prof.get("device_busy_share"),
            "launches": launches, **sizes}
    if ranks["deferred"].tobytes() != ranks["sync"].tobytes():
        raise AssertionError("pagerank100k: deferred and synchronous ranks "
                             "differ")
    extra = [(d["label"], d["attempts"] - s["attempts"],
              d["exchanges"] - d["broadcasts"])
             for d, s in zip(entries["deferred"], entries["sync"])]
    if (len(entries["deferred"]) != len(entries["sync"]) or any(
            x not in (0, 1) or x and not d["settle_replayed"]
            for (_, x, _), d in zip(extra, entries["deferred"]))):
        raise AssertionError(f"pagerank100k: attempts per stage differ "
                             f"between the forms beyond the settle's "
                             f"replays: {extra}")
    more = sum(x * legs for _, x, legs in extra)
    diff = {k: launched["deferred"][k] - launched["sync"][k]
            for k in TPU_KERNEL}
    # a replayed pure hash leg may probe its new input again
    diff["hist_buckets"] -= probes["deferred"] - probes["sync"]
    if any(diff[k] != more for k in PER_EXCHANGE) or (
            not more and any(diff.values())):
        raise AssertionError(f"pagerank100k: launches {launched} differ "
                             f"by other than the {more} exchanges the "
                             f"settle re-ran")
    forms["settle_extra"] = {"replayed": [(lbl, legs) for lbl, x, legs
                                          in extra if x],
                             "exchanges": more, "launch_diff": diff}
    turns = collections.defaultdict(list)
    for form in ("deferred", "sync", "sync", "deferred"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        app(ctxs[form])
        torch.cuda.synchronize()
        turns[form].append(time.perf_counter() - t0)
    for form, walls in turns.items():
        forms[form]["turn_walls_s"] = walls
        forms[form]["turn_wall_mean_s"] = sum(walls) / len(walls)
    return forms


def settle_runs(port, hk, ts, tera, li, orders, held) -> dict:
    """terasort1m and skewjoin6m in the default (deferred) form with an
    event log: the results exactly numpy's, the ``settle_replay`` events
    naming exactly the stages whose log entry says ``settle_replayed``
    (each of them one attempt more), the launches equal to the
    executor's exchange attempts, replays included; with
    ``max_capacity_retries=0`` the overflow raises CapacityError at the
    settle."""
    from dryad_tpu_torch.exec.executor import CapacityError
    from dryad_tpu_torch.utils.events import EventLog
    data, sml = tera

    def tera_app(c):
        return ts.terasort_query(c.from_columns(data, str_max_len=sml)) \
            .collect()

    def tera_ok(out, runs):
        keys = np.array(data["key"], dtype="S10")
        order = np.lexsort((data["payload"], keys))
        if (out["key"] != keys[order].tolist()
                or not np.array_equal(out["payload"],
                                      data["payload"][order])):
            raise AssertionError("terasort1m settle: not the sorted pairs")
        return {"rows": len(out["key"])}

    apps = {
        "terasort1m": (tera_app, tera_ok),
        "skewjoin6m": (
            lambda c: skew_join_query(c, li, orders, "custkey"),
            lambda out, runs: check_skew_join(out, li, orders, "custkey",
                                              runs, salted=True)),
    }
    res = {}
    for label, (app, check) in apps.items():
        log = EventLog()
        ctx = port.Context(device="cuda", nparts=NPARTS, event_log=log)
        hk.capture = {}
        out, launches, load, qs, runs = run_app(port, hk, app, ctx=ctx)
        captured, hk.capture = hk.capture, None
        held(f"{label}_settle", launches, captured)
        del captured
        sizes = check(out, runs)
        del out
        stages = loop_stages(runs)
        check_per_exchange(f"{label}_settle", launches,
                           stages["exchange_attempts"],
                           stages["broadcast_attempts"], stages["probes"])
        named = sorted(sid for e in log.of_type("settle_replay")
                       for sid in e["stages"])
        entries = [st for r in runs for st in r["stages"]]
        flagged = sorted(st["stage"] for st in entries
                         if st["settle_replayed"])
        if not named or named != flagged or any(
                st["attempts"] < 2 for st in entries
                if st["settle_replayed"]):
            raise AssertionError(f"{label}: settle_replay names {named}, "
                                 f"the stage log flags {flagged}")
        cfg = port.JobConfig(max_capacity_retries=0)
        try:
            app(port.Context(device="cuda", nparts=NPARTS, config=cfg))
        except CapacityError as e:
            if "deferred settle" not in str(e):
                raise
            raised = str(e)
        else:
            raise AssertionError(f"{label}: no CapacityError at the settle "
                                 f"with max_capacity_retries=0")
        res[label] = {
            **sizes, "launches": launches,
            "settle_replays": [e["stages"] for e in
                               log.of_type("settle_replay")],
            "replayed": [(st["label"], st["attempts"]) for st in entries
                         if st["settle_replayed"]],
            "exchange_attempts": stages["exchange_attempts"],
            "need_reads": ctx.executor.host_reads, "load_s": load,
            "query_s": qs, "zero_retries": raised}
    return res


def lineage_run(port, hk, li, orders, held) -> dict:
    """A Run over skewjoin6m's plan (the revenue per customer, before the
    cache): every stage invalidated, then the output again: the same rows
    bit for bit, one ``stage_replay`` event per stage, ``failures`` the
    stage count; with ``failure_budget=2`` the third invalidation raises
    FailureBudgetExceeded."""
    from dryad_tpu_torch.exec.data import pdata_to_host
    from dryad_tpu_torch.exec.recovery import FailureBudgetExceeded, Run
    from dryad_tpu_torch.utils.events import EventLog
    log = EventLog()
    ctx = port.Context(device="cuda", nparts=NPARTS)
    graph = skew_join_groups(ctx, li, orders, "custkey").plan()
    hk.reset_launches()
    hk.capture = {}
    run = Run(ctx.executor, graph, event=log)
    first = pdata_to_host(run.output())
    n = len(graph.stages)
    for sid in range(n):
        run.invalidate(sid)
    again = pdata_to_host(run.output())
    captured, hk.capture = hk.capture, None
    held("skewjoin6m_lineage", dict(hk.launches), captured)
    del captured

    replays = log.of_type("stage_replay")
    if not _rows_equal(first, again) or [e["stage"] for e in replays] != \
            list(range(n)) or run.failures != n or \
            [e["failures"] for e in replays] != list(range(1, n + 1)):
        raise AssertionError(f"skewjoin6m lineage: replay of {n} stages "
                             f"not exact, or events {replays}")
    budget = Run(ctx.executor, graph, failure_budget=2)
    budget.output()
    for i in range(1, 4):
        try:
            budget.invalidate(graph.out_stage)
        except FailureBudgetExceeded:
            if i != 3:
                raise
            break
    else:
        raise AssertionError("skewjoin6m lineage: no FailureBudgetExceeded "
                             "at the third invalidation")
    return {"stages": n, "failures": run.failures,
            "rows": len(first["custkey"]), "budget_raised_at": i}


def q1_columns(c):
    """TPC-H Q1's columns from tpch_tables' lineitems: flag = okey % 3,
    status = qty % 2, disc = (price % 11) / 100 and net = price x
    (1 - disc) in f32."""
    import torch
    disc = (c["price"] % 11).to(torch.float32) / 100
    return dict(c, flag=c["okey"] % 3, status=c["qty"] % 2, disc=disc,
                net=c["price"].to(torch.float32) * (1 - disc))


def q1_store_query(ctx, li):
    """Q1's shape as phase 10 computes it, over the flat lineitems: one
    materialized scan (the Tee), forked by flag, each branch grouped by
    status (sums, a mean, a count), tagged and concatenated."""
    import torch
    branches = ctx.from_columns(li).select(q1_columns).fork_on(
        "flag", [0, 1, 2])
    outs = [b.group_by(["status"], Q1_AGGS).select(
        lambda c, f=f: dict(c, flag=torch.full_like(c["status"], f)))
        for f, b in enumerate(branches)]
    return outs[0].concat(outs[1]).concat(outs[2])


def check_q1_store(out, li) -> int:
    """Counts and integer sums exactly; f32 sums within 16 eps sum|v|
    over the group, the mean within that over its count."""
    price = li["price"]
    disc = ((price % 11) / 100).astype(np.float32)
    cols = {"qty": li["qty"], "price": price, "disc": disc,
            "net": price.astype(np.float32) * (np.float32(1) - disc)}
    flag, status = li["okey"] % 3, li["qty"] % 2
    got = {(int(f), int(s)): i for i, (f, s) in enumerate(zip(
        np.asarray(out["flag"]).tolist(), np.asarray(out["status"]).tolist()))}
    if sorted(got) != [(f, s) for f in range(3) for s in range(2)]:
        raise AssertionError(f"q1 store: groups {sorted(got)}")
    for (f, s), i in got.items():
        g = (flag == f) & (status == s)
        n = int(g.sum())
        if (int(out["count_order"][i]) != n
                or int(out["sum_qty"][i]) != int(cols["qty"][g].sum())
                or int(out["sum_base_price"][i]) != int(price[g].sum())):
            raise AssertionError(f"q1 store: group {(f, s)} counts or "
                                 f"integer sums differ from numpy")
        for col, src in (("sum_disc_price", "net"), ("avg_disc", "disc")):
            v = cols[src][g].astype(np.float64)
            bound, want = 16 * EPS * np.abs(v).sum(), v.sum()
            if col == "avg_disc":
                want, bound = want / n, bound / n
            if not abs(float(out[col][i]) - want) <= bound:
                raise AssertionError(f"q1 store: {col} of {(f, s)}")
    return len(got)


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def spill_runs(port, hk, li, tmp, held) -> dict:
    """Spill and resume at full size: run 1 of the Q1-shaped plan with
    ``spill_dir`` spills every stage (``stage_spilled``); a fresh
    executor and Run over the same graph return the same rows with zero
    ``stage_done`` and one ``stage_restored`` (the output stage);
    ``invalidate(out, drop_spill=True)`` recomputes only the output
    stage.  Store writes and reads are timed where they happen (the
    store module's functions wrapped for the phase)."""
    import torch
    from dryad_tpu_torch.exec.data import pdata_to_host
    from dryad_tpu_torch.exec.executor import Executor
    from dryad_tpu_torch.exec.recovery import Run
    from dryad_tpu_torch.io import store
    from dryad_tpu_torch.utils.events import EventLog
    spent = collections.Counter()
    originals = {n: getattr(store, n) for n in ("write_store", "read_store",
                                                "verify_checksums")}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return call

    spill = os.path.join(tmp, "spill")
    for n, fn in originals.items():
        setattr(store, n, timed(n, fn))
    try:
        ctx = port.Context(device="cuda", nparts=NPARTS)
        graph = q1_store_query(ctx, li).plan()
        out_sid = graph.out_stage
        log1, log2, log3 = EventLog(), EventLog(), EventLog()
        hk.reset_launches()
        hk.capture = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out1 = pdata_to_host(Run(ctx.executor, graph, spill_dir=spill,
                                 event=log1).output())
        run1_s = time.perf_counter() - t0
        captured, hk.capture = hk.capture, None
        held("q1spill6m", dict(hk.launches), captured)
        del captured
        groups = check_q1_store(out1, li)
        write_s = spent["write_store"]
        spill_bytes = _dir_bytes(spill)
        out2 = pdata_to_host(Run(Executor(ctx.mesh), graph,
                                 spill_dir=spill, event=log2).output())
        run3 = Run(Executor(ctx.mesh), graph, spill_dir=spill, event=log3)
        run3.invalidate(out_sid, count_failure=False, drop_spill=True)
        out3 = pdata_to_host(run3.output())
        biggest = max((os.path.join(spill, d) for d in os.listdir(spill)),
                      key=_dir_bytes)
        spent["read_store"] = spent["verify_checksums"] = 0.0
        store.read_store(biggest, ctx.mesh)
    finally:
        for n, fn in originals.items():
            setattr(store, n, fn)
    n = len(graph.stages)
    spilled = sorted(e["stage"] for e in log1.of_type("stage_spilled"))
    rest = [e["stage"] for e in log2.of_type("stage_restored")]
    redone = [e["stage"] for e in log3.of_type("stage_done")]
    same = all(_rows_equal(out1, o) for o in (out2, out3))
    if (spilled != list(range(n)) or log2.of_type("stage_done")
            or rest != [out_sid] or redone != [out_sid] or not same):
        raise AssertionError(f"q1 spill: spilled {spilled}, restored "
                             f"{rest}, recomputed {redone}, rows equal "
                             f"{same}")
    big = _dir_bytes(biggest)
    return {"lineitems": len(li["okey"]), "groups": groups, "stages": n,
            "spilled": len(spilled), "spill_bytes": spill_bytes,
            "run1_s": run1_s, "write_s": write_s,
            "write_gb_s": spill_bytes / write_s / 1e9,
            "read_store": os.path.basename(biggest), "read_bytes": big,
            "read_s": spent["read_store"],
            "read_gb_s": big / spent["read_store"] / 1e9,
            "checksum_s": spent["verify_checksums"],
            "checksum_gb_s": big / spent["verify_checksums"] / 1e9,
            "restored": rest, "recomputed": redone}


def _rows_equal(a, b) -> bool:
    """Two collected tables equal column for column, in order."""
    return sorted(a) == sorted(b) and all(
        (a[k] == b[k]) if isinstance(a[k], list)
        else np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes()
        for k in a)


def store_round_trips(port, hk, li, orders, tmp, held) -> dict:
    """The lineitem table through ``to_store`` / ``from_store`` (equal
    rows, in order); the orders hash-partitioned by custkey, reloaded
    with its claim (no ``=>hash`` in the plan, the group-by numpy's);
    the orders with gzip (smaller than raw, equal rows); one flipped
    byte raises StoreIntegrityError naming partition 3."""
    import torch
    from dryad_tpu_torch.io.store import StoreIntegrityError
    ctx = port.Context(device="cuda", nparts=NPARTS)
    paths = {k: os.path.join(tmp, k) for k in ("li", "hashed", "gz", "raw")}
    hk.reset_launches()
    hk.capture = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx.from_columns(li).to_store(paths["li"])
    li_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ctx.from_store(paths["li"]).collect()
    li_read_s = time.perf_counter() - t0
    if not _rows_equal(back, li):
        raise AssertionError("store: the lineitem table came back other")
    del back
    ctx.from_columns(orders).hash_partition(["custkey"]).to_store(
        paths["hashed"])
    q = ctx.from_store(paths["hashed"]).group_by(
        ["custkey"], {"n": ("count", None), "p": ("sum", "prio")})
    plan = q.explain()
    got = q.collect()
    ck = orders["custkey"]
    keys = np.flatnonzero(np.bincount(ck))
    o = np.argsort(got["custkey"])
    if "=>hash" in plan or not (
            np.array_equal(got["custkey"][o], keys)
            and np.array_equal(got["n"][o], np.bincount(ck)[keys])
            and np.array_equal(got["p"][o], np.bincount(
                ck, weights=orders["prio"]).astype(np.int64)[keys])):
        raise AssertionError(f"store: the hash-partitioned reload lost its "
                             f"claim or its groups:\n{plan}")
    ods = ctx.from_columns(orders)
    ods.to_store(paths["gz"], compression="gzip")
    ods.to_store(paths["raw"])
    gz, raw = _dir_bytes(paths["gz"]), _dir_bytes(paths["raw"])
    if not (gz < raw and _rows_equal(ctx.from_store(paths["gz"]).collect(),
                                     orders)):
        raise AssertionError(f"store: gzip {gz} against raw {raw} bytes")
    captured, hk.capture = hk.capture, None
    held("store_rt", dict(hk.launches), captured)
    del captured
    part = os.path.join(paths["raw"], "part-00003.bin")
    with open(part, "r+b") as f:
        f.seek(os.path.getsize(part) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    try:
        ctx.from_store(paths["raw"])
    except StoreIntegrityError as e:
        if "partition 3" not in str(e):
            raise
        flipped = str(e)
    else:
        raise AssertionError("store: a flipped byte went unnoticed")
    li_bytes = _dir_bytes(paths["li"])
    return {"lineitem_bytes": li_bytes, "lineitem_write_s": li_write_s,
            "lineitem_write_gb_s": li_bytes / li_write_s / 1e9,
            "lineitem_read_s": li_read_s,
            "lineitem_read_gb_s": li_bytes / li_read_s / 1e9,
            "hashed_plan": plan, "customers": len(keys),
            "orders_gzip_bytes": gz, "orders_raw_bytes": raw,
            "flipped_byte": flipped[:120]}


def read_text_run(port, hk, wc, lines, want, tmp, held) -> dict:
    """The bench12 corpus written to a file, read back by ``read_text``
    (96-byte lines, as phase 3 loads it) and counted by WordCount: the
    counts must equal phase 3's in-memory run's."""
    import torch
    path = os.path.join(tmp, "bench12.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    ctx = port.Context(device="cuda", nparts=NPARTS)
    per_part = -(-len(lines) // NPARTS)
    hk.reset_launches()
    hk.capture = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = ctx.read_text(path, max_line_len=96)
    torch.cuda.synchronize()
    load = time.perf_counter() - t0
    out = wc.wordcount_query(ds, tokens_per_partition=per_part * 10).collect()
    query = time.perf_counter() - t0 - load
    captured, hk.capture = hk.capture, None
    held("readtext1m", dict(hk.launches), captured)
    del captured
    got = dict(zip(out["line"], (int(v) for v in out["n"])))
    if got != want:
        raise AssertionError("read_text: WordCount over the file differs "
                             "from the in-memory run")
    return {"lines": len(lines), "file_bytes": os.path.getsize(path),
            "words": len(got), "load_s": load, "query_s": query}


# ---------------------------------------------------------------------------
# phase 12: adaptive execution, the static cost model, the oracle


SHRINK_CAP = 1 << 17        # smoke_adapt's declared bound (bench.py:277)
Q17_PARTS = 200_000         # TPC-H SF1 PART
Q17_BRANDS, Q17_CONTAINERS = 25, 40    # TPC-H spec 4.2.3: P_BRAND x
                                       # P_CONTAINER, 1,000 combinations
Q17_BRAND, Q17_CONTAINER = 12, 7       # the one pair Q17 filters on
ORACLE_ROWS, ORACLE_LINES = 20_000, 2_000


def shrink_table(n: int, seed: int = 0) -> dict:
    """bench.py's ``smoke_adapt`` table: 90 % of rows on key 0, the rest
    uniform over keys 1-999, ``v`` in [0, 10), numpy seed ``seed``."""
    rng = np.random.RandomState(seed)
    k = np.where(rng.rand(n) < 0.9, 0,
                 rng.randint(1, 1000, n)).astype(np.int32)
    return {"k": k, "v": rng.randint(0, 10, n).astype(np.int32)}


def shrink_query(ctx, t):
    """``smoke_adapt``'s query: the group-by's ~1,000 rows carry the
    declared 131,072-row bound into the range exchange of a global sort,
    by s descending."""
    return (ctx.from_columns(t).group_by(["k"], {"s": ("sum", "v")})
            .with_capacity(SHRINK_CAP).order_by([("s", True)]))


def check_shrink(out, t) -> dict:
    """The (k, s) rows exactly numpy's per-key sums, s non-increasing."""
    keys, inv = np.unique(t["k"], return_inverse=True)
    sums = np.bincount(inv, weights=t["v"]).astype(np.int64)
    got = sorted(zip(out["k"].tolist(), out["s"].tolist()))
    if got != sorted(zip(keys.tolist(), sums.tolist())) or np.any(
            np.diff(np.asarray(out["s"], np.int64)) > 0):
        raise AssertionError("adaptshrink: not numpy's per-key sums by s "
                             "descending")
    return {"rows": len(t["k"]), "groups": len(got)}


def q17_tables(n_items: int, seed: int = 0):
    """TPC-H Q17's two tables: LINEITEM's ``partkey`` uniform over the
    200,000 parts and ``qty`` (f32) in [1, 50]; PART's ``partkey`` =
    1..200,000 with ``brand`` in [0, 25) and ``container`` in [0, 40)
    (numpy seed ``seed``): one (brand, container) holds about 200 parts."""
    rng = np.random.RandomState(seed)
    li = {"partkey": rng.randint(1, Q17_PARTS + 1, n_items).astype(
              np.int32),
          "qty": rng.randint(1, 51, n_items).astype(np.float32)}
    part = {"partkey": np.arange(1, Q17_PARTS + 1, dtype=np.int32),
            "brand": rng.randint(0, Q17_BRANDS, Q17_PARTS).astype(np.int32),
            "container": rng.randint(0, Q17_CONTAINERS, Q17_PARTS).astype(
                np.int32)}
    return li, part


def _q17_big(c):
    return {"pk": c["partkey"], "qsum": c["qsum"], "n": c["n"]}


def _q17_small(c):
    return {"ppk": c["partkey"], "np": c["np"]}


def _q17_part(c):
    return (c["brand"] == Q17_BRAND) & (c["container"] == Q17_CONTAINER)


def q17_query(ctx, li, part):
    """Q17's shape (tests/test_adapt.py:492-517): lineitem's quantity sum
    and count per part, joined with the parts of one brand and container
    grouped by part key; each side renamed by a select, so both legs
    hash-exchange as planned."""
    big = ctx.from_columns(li).group_by(
        ["partkey"], {"qsum": ("sum", "qty"), "n": ("count", None)}) \
        .select(_q17_big, label="ren")
    small = ctx.from_columns(part).where(_q17_part, label="brand").group_by(
        ["partkey"], {"np": ("count", None)}).select(_q17_small,
                                                     label="ren")
    return big.join(small, ["pk"], ["ppk"])


def check_q17(out, tables) -> dict:
    """Against numpy: the parts of the brand and container that have
    lineitems, each with its lineitem count exactly and its f32 quantity
    sum within 16 eps sum|qty|."""
    li, part = tables
    keep = part["partkey"][(part["brand"] == Q17_BRAND)
                           & (part["container"] == Q17_CONTAINER)]
    sel = np.isin(li["partkey"], keep)
    pk, inv = np.unique(li["partkey"][sel], return_inverse=True)
    n = np.bincount(inv)
    q = np.bincount(inv, weights=li["qty"][sel].astype(np.float64))
    o = np.argsort(out["pk"])
    if not (np.array_equal(out["pk"][o], pk)
            and np.array_equal(out["n"][o], n)
            and np.all(out["np"] == 1)):
        raise AssertionError("q17promote: parts or counts differ from numpy")
    err = np.abs(out["qsum"][o] - q)
    if not np.all(err <= 16 * EPS * q):
        raise AssertionError("q17promote: a quantity sum is outside the "
                             "f32 bound")
    return {"lineitems": len(li["partkey"]), "parts": len(keep),
            "rows": len(pk), "max_abs_err": float(err.max(initial=0))}


def demote_tables(n_orders: int, seed: int = 0):
    """ORDERS' ``custkey`` (as ``tpch_tables``: uniform over the
    customers not divisible by 3) and f32 ``totalprice``; CUSTOMER's
    ``custkey`` = 1..n_orders / 10 and f32 ``acctbal`` in
    [-999.99, 9999.99) (TPC-H's ranges; numpy seed ``seed``)."""
    rng = np.random.RandomState(seed)
    ck = np.arange(1, n_orders // 10 + 1, dtype=np.int32)
    allowed = ck[ck % 3 != 0]
    orders = {"custkey": allowed[rng.randint(0, len(allowed), n_orders)],
              "totalprice": rng.uniform(850, 550_000, n_orders).astype(
                  np.float32)}
    cust = {"custkey": ck, "acctbal": rng.uniform(
        -999.99, 9999.99, len(ck)).astype(np.float32)}
    return orders, cust


def _demote_left(c):
    return {"ck": c["custkey"], "n": c["n"], "spend": c["spend"]}


def _demote_right(c):
    return {"cck": c["custkey"], "bal": c["bal"]}


def demote_query(ctx, orders, cust):
    """Orders per customer (count, f32 spend) joined with
    ``broadcast=True`` to the customers' largest balance
    (tests/test_adapt.py:520-550): the planner broadcasts a build side
    that measures larger than the probe side."""
    left = ctx.from_columns(orders).group_by(
        ["custkey"], {"n": ("count", None), "spend": ("sum", "totalprice")}
    ).select(_demote_left, label="ren")
    right = ctx.from_columns(cust).group_by(
        ["custkey"], {"bal": ("max", "acctbal")}).select(_demote_right,
                                                         label="ren")
    return left.join(right, ["ck"], ["cck"], broadcast=True)


def check_demote(out, tables) -> dict:
    """Against numpy: every customer with orders, its order count and
    balance exactly, its f32 spend within 16 eps sum|price|."""
    orders, cust = tables
    ck, inv = np.unique(orders["custkey"], return_inverse=True)
    n = np.bincount(inv)
    spend = np.bincount(inv, weights=orders["totalprice"].astype(
        np.float64))
    o = np.argsort(out["ck"])
    if not (np.array_equal(out["ck"][o], ck)
            and np.array_equal(out["n"][o], n)
            and np.array_equal(out["bal"][o], cust["acctbal"][ck - 1])):
        raise AssertionError("demote: customers, counts or balances differ "
                             "from numpy")
    err = np.abs(out["spend"][o] - spend)
    if not np.all(err <= 16 * EPS * spend):
        raise AssertionError("demote: a spend is outside the f32 bound")
    return {"orders": len(orders["custkey"]), "customers": len(ck),
            "rows": len(ck), "max_abs_err": float(err.max(initial=0))}


def phase12_cells(shrink_rows: int, q17_items: int, demote_orders: int
                  ) -> dict:
    """label -> (tables, query(ctx, tables) -> Dataset, check(out,
    tables), the rewrite adaptation must record)."""
    return {
        "adaptshrink6m": (shrink_table(shrink_rows), shrink_query,
                          check_shrink, "repartition_shrink"),
        "q17promote6m": (q17_tables(q17_items),
                         lambda c, t: q17_query(c, *t), check_q17,
                         "broadcast_promote"),
        "demote1m": (demote_tables(demote_orders),
                     lambda c, t: demote_query(c, *t), check_demote,
                     "broadcast_demote"),
    }


def cost_checked(port, hk, ctx, reports) -> None:
    """``ctx.executor.run`` estimates each graph it is given
    (``analysis.cost.estimate_graph``) and runs it with the report, so the
    run cross-checks every stage (``cost_model_miss`` events in the
    context's log).  The estimate must launch no port kernel and allocate
    nothing on the card.  Lasts until ``run_app`` restores the method."""
    import torch
    from dryad_tpu_torch.analysis.cost import estimate_graph
    run = ctx.executor.run

    def checked(graph, bindings=None, **kw):
        launches = dict(hk.launches)
        allocs = torch.cuda.memory_stats().get("allocation.all.allocated")
        rep = estimate_graph(graph, NPARTS, config=ctx.config)
        if (dict(hk.launches) != launches or torch.cuda.memory_stats().get(
                "allocation.all.allocated") != allocs):
            raise AssertionError("the cost model launched a kernel or "
                                 "allocated on the card")
        reports.append(rep)
        return run(graph, bindings, **{**kw, "cost_report": rep})

    ctx.executor.run = checked


def cost_summary(label, log, reports) -> dict:
    """A cost-checked run's misses (each printed with its stage and what
    was measured against what was predicted), its reports' stage and
    approximate-stage counts; a miss fails the phase."""
    misses = log.of_type("cost_model_miss")
    for m in misses:
        print(f"cost_model_miss {label}: stage {m['stage']} ({m['label']}) "
              f"{m['what']} measured {m['measured']} predicted "
              f"{m['predicted']}", flush=True)
    if misses:
        raise AssertionError(f"{label}: {len(misses)} cost_model_miss")
    return {"misses": 0, "reports": len(reports),
            "stages": sum(len(r.stages) for r in reports),
            "approx_stages": sum(s.approx for r in reports
                                 for s in r.stages)}


def adapt_cells(port, hk, cells, out_dir, held) -> dict:
    """Each cell adaptive off and on, each in a context of its own with
    an event log: a cold run of each (off first, cost-checked), its
    kernel calls held, its launches against the executor's log; then
    three warm runs of each in turns (off, on, ...), one profiled warm
    run of each (busy share).  On must record the cell's rewrite, off
    none; the rows of both and of numpy agree.  Per mode: cold and warm
    walls, NEED reads per run, launches, rewrites, the order_by stage's
    output bytes (``shuffle_bytes``)."""
    import torch
    from dryad_tpu_torch.utils.events import EventLog
    res = {}
    for label, (tables, query, check, kind) in cells.items():
        ctxs, logs, per = {}, {}, {}
        for mode in ("off", "on"):
            logs[mode] = EventLog()
            ctxs[mode] = port.Context(
                device="cuda", nparts=NPARTS, event_log=logs[mode],
                config=port.JobConfig(adaptive=mode))
        outs = {}
        reports = []
        for mode in ("off", "on"):
            ctx = ctxs[mode]
            if mode == "off":
                cost_checked(port, hk, ctx, reports)
            reads0 = ctx.executor.host_reads
            hk.capture = {}
            out, launches, load, qs, runs = run_app(
                port, hk, lambda c: query(c, tables).collect(), ctx=ctx)
            captured, hk.capture = hk.capture, None
            held(f"{label}_{mode}", launches, captured)
            del captured
            stages = loop_stages(runs)
            check_per_exchange(f"{label}_{mode}", launches,
                               stages["exchange_attempts"],
                               stages["broadcast_attempts"],
                               stages["probes"])
            sizes = check(out, tables)
            outs[mode] = out
            rw = logs[mode].of_type("graph_rewrite")
            per[mode] = {"launches": launches, "cold_wall_s": load + qs,
                         "cold_load_s": load, "cold_query_s": qs,
                         "need_reads_cold": ctx.executor.host_reads - reads0,
                         "exchanging_stages": stages["outside_loop"],
                         "rewrites": [{k: e.get(k) for k in (
                             "kind", "stage", "cap_before", "cap_after",
                             "slack_before", "slack_after", "left_rows",
                             "right_rows")} for e in rw]}
            if mode == "off":
                per[mode]["cost"] = cost_summary(label, logs[mode], reports)
        kinds = [e["kind"] for e in per["on"]["rewrites"]]
        if kind not in kinds or per["off"]["rewrites"]:
            raise AssertionError(f"{label}: rewrites on {kinds}, off "
                                 f"{per['off']['rewrites']}")
        if _row_set(outs["on"]) != _row_set(outs["off"]):
            raise AssertionError(f"{label}: adaptive on and off differ")
        del outs
        walls = collections.defaultdict(list)
        reads = collections.defaultdict(list)
        for mode in ("off", "on") * 3:
            ctx = ctxs[mode]
            reads0 = ctx.executor.host_reads
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            query(ctx, tables).collect()
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            reads[mode].append(ctx.executor.host_reads - reads0)
        for mode in ("off", "on"):
            ctx = ctxs[mode]
            n0 = len(logs[mode].events)
            prof = profile_path(lambda: run_app(
                port, hk, lambda c: query(c, tables).collect(),
                ctx=ctx)[:4], f"{label}_{mode}", out_dir, pack=False)
            sort_bytes = [e["out_bytes"] for e in logs[mode].events[n0:]
                          if e["event"] == "stage_done"
                          and e["label"] == "orderby"]
            per[mode].update({
                "warm_walls_s": walls[mode],
                "warm_wall_mean_s": sum(walls[mode]) / len(walls[mode]),
                "need_reads_warm": reads[mode],
                "profiled_wall_s": prof["wall_s"],
                "profiled_device_ms": prof["device_ms"],
                "device_busy_share": prof.get("device_busy_share"),
                "orderby_out_bytes": sort_bytes})
        res[label] = {**sizes, "nparts": NPARTS, **per}
    return res


def cost_runs(port, hk, apps, held) -> dict:
    """Each BASELINE app once at its phase size, every executor run it
    makes given ``estimate_graph``'s report of its graph
    (``cost_checked``): no ``cost_model_miss``, and each app's result
    held by its own check."""
    from dryad_tpu_torch.utils.events import EventLog
    res = {}
    for label, (app, check) in apps.items():
        log, reports = EventLog(), []
        ctx = port.Context(device="cuda", nparts=NPARTS, event_log=log)
        cost_checked(port, hk, ctx, reports)
        hk.capture = {}
        out, launches, load, qs, runs = run_app(port, hk, app, ctx=ctx)
        captured, hk.capture = hk.capture, None
        held(f"{label}_cost", launches, captured)
        del captured
        check(out)
        res[label] = {**cost_summary(label, log, reports),
                      "executor_runs": len(runs), "load_s": load,
                      "query_s": qs}
    return res


def _row_set(t) -> list:
    """A table's rows as a sorted list of tuples, columns in name order
    (strings as bytes)."""
    return sorted(zip(*[[bytes(x) for x in t[c]] if isinstance(t[c], list)
                        else np.asarray(t[c]).tolist() for c in sorted(t)]))


def _rows_within(a, b, f32) -> bool:
    """Two tables as row multisets: every column exact but those in
    ``f32``, within 16 eps x the column's sum |v| (in each cell a float
    column sorts after a unique key column, so rows pair up)."""
    if sorted(a) != sorted(b):
        return False
    ra, rb = _row_set(a), _row_set(b)
    tol = [16 * EPS * float(np.abs(np.asarray(b[c], np.float64)).sum())
           if c in f32 else None for c in sorted(b)]
    return len(ra) == len(rb) and all(
        u == w if t is None else abs(u - w) <= t
        for x, y in zip(ra, rb) for u, w, t in zip(x, y, tol))


def oracle_runs(port, hk, cells, wc, lines, held) -> dict:
    """The three cells at ORACLE_ROWS rows and WordCount over the first
    ORACLE_LINES lines of bench12, each on the card and again through
    ``Context(device="cuda", local_debug=True)`` (the sequential oracle
    over the sources' host tables): equal as row multisets, f32 columns
    within the bound."""
    import torch
    f32 = {"adaptshrink6m": (), "q17promote6m": ("qsum",),
           "demote1m": ("spend",)}
    res = {}
    apps = {label: (lambda c, q=q, t=t: q(c, t).collect(), f32[label])
            for label, (t, q, _chk, _k) in cells.items()}
    apps["wordcount_bench12"] = (lambda c: wc.wordcount_query(
        c.from_columns({"line": lines}, str_max_len=96),
        tokens_per_partition=10 * len(lines)).collect(), ())
    for label, (app, cols) in apps.items():
        hk.capture = {}
        card, launches, _load, qs, _runs = run_app(port, hk, app)
        captured, hk.capture = hk.capture, None
        held(f"{label}_oracle", launches, captured)
        del captured
        dbg = port.Context(device="cuda", nparts=NPARTS, local_debug=True)
        t0 = time.perf_counter()
        want = app(dbg)
        oracle_s = time.perf_counter() - t0
        if dbg.executor.stage_log or not _rows_within(card, want, cols):
            raise AssertionError(f"{label}: the card and local_debug "
                                 f"disagree")
        torch.cuda.synchronize()
        res[label] = {"rows": len(next(iter(card.values()))),
                      "card_query_s": qs, "oracle_s": oracle_s}
    return res


# ---------------------------------------------------------------------------
# phase 13: out-of-core streaming at full size


@dataclasses.dataclass(frozen=True)
class Phase13Sizes:
    """Phase 13's sizes: the streamed TeraSort's records (and the small
    run its peak device memory is held against), its chunk, the
    ``terasort_ooc`` app's records; PageRank's nodes (edges 10x), k-means'
    points, the TPC-H lineitems whose orders and customers Q13 joins, the
    chunk of those three, the text stream's chunk."""

    records: int = 10_000_000
    small_records: int = 1_000_000
    record_chunk: int = 262_144
    app_records: int = 2_000_000
    nodes: int = 100_000
    points: int = 500_000
    point_chunk: int = 65_536
    lineitems: int = 6_000_000
    stream_chunk: int = 65_536
    text_chunk: int = 65_536


PEAK_RATIO = 1.5     # peak device memory at 10x the records, at most
# the kernels each phase-13 cell must launch (a one-partition plan has no
# exchange: slot_expand and slot_compact never launch); k-means' f32
# group sums take the small-key lowering (a one-hot product), not the
# compensated scan
STREAM_MUST = {"terasortooc10m": ("hist_buckets",),
               "pagerankstream100k": ("hist_buckets", "prefix_sum",
                                      "prefix_sum2"),
               "kmeansstream500k": ("hist_buckets",),
               "q13stream1m5": ("hist_buckets", "prefix_sum"),
               "readtextstream1m": ("hist_buckets", "prefix_sum")}


def teragen_chunk(i: int, rows: int, seed: int = 0):
    """Chunk i of a chunk-wise TeraGen (``terasort_ooc``'s chunk seeds):
    the records of ``terasort.gen_records(rows, seed * 1_000_003 + i)``
    as a (keys [rows, 10] u8, payload [rows] i32) pair, with no Python
    bytes per record."""
    rng = np.random.RandomState(seed * 1_000_003 + i)
    keys = rng.randint(ord(" "), ord("~") + 1, (rows, 10), dtype=np.uint8)
    return keys, rng.randint(0, 2**31, rows).astype(np.int32)


def write_teragen(ooc, path: str, n: int, chunk: int):
    """n TeraGen records written chunk by chunk with
    ``write_chunks_to_store``; returns the input (keys, payload) for the
    oracle."""
    schema = {"key": {"kind": "str", "max_len": 10},
              "payload": {"kind": "dense", "dtype": "int32", "shape": []}}
    keys = np.empty((n, 10), np.uint8)
    pay = np.empty(n, np.int32)

    def chunks():
        for i in range(-(-n // chunk)):
            s = i * chunk
            rows = min(chunk, n - s)
            keys[s:s + rows], pay[s:s + rows] = teragen_chunk(i, rows)
            yield ooc.HChunk({"key": (keys[s:s + rows],
                                      np.full(rows, 10, np.int32)),
                              "payload": pay[s:s + rows]}, rows)
    ooc.write_chunks_to_store(path, chunks(), schema)
    return keys, pay


def _key_lanes(keys):
    """10-byte keys as (first 8 bytes, last 2) big-endian integers: their
    lexicographic order is the keys' byte order."""
    k = np.ascontiguousarray(keys)
    return (k[:, :8].copy().view(">u8")[:, 0].astype(np.uint64),
            k[:, 8:].copy().view(">u2")[:, 0].astype(np.uint64))


def read_sorted(ooc, path: str):
    """A sorted store read back: (keys [n, 10] u8, payload)."""
    src = ooc.ChunkSource.from_store(path, 1 << 22)
    out = ooc._concat_hchunks(src.schema, list(src))
    if out.n and not (out.cols["key"][1] == 10).all():
        raise AssertionError("terasort: a key lost its 10 bytes")
    return out.cols["key"][0], out.cols["payload"]


def check_terasort_store(label, got, want) -> dict:
    """The output rows against the input's: the count, keys
    non-decreasing as bytes, and the (key, payload) multiset equal
    (both sorted by key then payload, numpy's lexsort)."""
    gk, gp = got
    wk, wp = want
    if len(gp) != len(wp):
        raise AssertionError(f"{label}: {len(gp)} rows, not {len(wp)}")
    hi, lo = _key_lanes(gk)
    if not ((hi[:-1] < hi[1:]) | ((hi[:-1] == hi[1:])
                                  & (lo[:-1] <= lo[1:]))).all():
        raise AssertionError(f"{label}: keys not non-decreasing")
    whi, wlo = _key_lanes(wk)
    # sorted by key already: only rows of equal keys (rare for 10 random
    # bytes) need ordering by payload before the comparison
    tie = (hi[:-1] == hi[1:]) & (lo[:-1] == lo[1:])
    go = np.lexsort((gp, lo, hi)) if tie.any() else slice(None)
    wo = np.lexsort((wp, wlo, whi))
    if not (np.array_equal(hi[go], whi[wo]) and np.array_equal(lo[go],
                                                               wlo[wo])
            and np.array_equal(gp[go], wp[wo])):
        raise AssertionError(f"{label}: not the input's (key, payload) "
                             f"multiset")
    return {"rows": len(gp), "equal_key_pairs": int(tie.sum())}


def stream_run(port, hk, ooc, app, config, device="cuda", capture=False,
               syncs=False) -> dict:
    """One run of ``app(ctx)`` in a new ``Context`` with an event log:
    launch counters, the streamed path's copy counters and the peak device
    memory reset just before (the peak also as allocated above the bytes
    held before the run), read just after.  ``capture`` records the
    kernel calls (for ``hold_run``), ``syncs`` counts the host syncs
    (``counted_syncs``).  The streamed jobs' ``stream_stage_done`` events
    give the prefetch counters and each external sort's shape."""
    import torch
    from dryad_tpu_torch.utils.events import EventLog
    log = EventLog(level=2)
    ctx = port.Context(device=device, nparts=NPARTS, config=config,
                       event_log=log)
    cuda = device == "cuda"
    hk.reset_launches()
    ooc.reset_transfers()
    if capture:
        hk.capture = {}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0

    def go():
        t0 = time.perf_counter()
        out = app(ctx)
        if cuda:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    if syncs:
        (out, wall), n_syncs, sites = counted_syncs(go)
    else:
        (out, wall), n_syncs, sites = go(), None, None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    captured = hk.capture
    hk.capture = None
    done = [e for e in log.events if e["event"] == "stream_stage_done"]
    kinds = collections.Counter(e["event"] for e in log.events)
    chunks = ooc.transfers["h2d_chunks"]
    return {"out": out, "captured": captured, "launches": dict(hk.launches),
            "wall_s": wall, "chunks_to_device": chunks,
            "chunks_to_host": ooc.transfers["d2h_chunks"],
            "h2d_bytes": ooc.transfers["h2d_bytes"],
            "d2h_bytes": ooc.transfers["d2h_bytes"],
            "prefetched_chunks": sum(e["prefetch_chunks"] for e in done),
            "prefetch_stalls": sum(e["prefetch_stalls"] for e in done),
            "prefetch_stall_s": sum(e["prefetch_stall_s"] for e in done),
            "stream_jobs": len(done),
            "sorts": [s for e in done for s in e["sorts"]],
            "cache_writes": kinds["ooc_cache_write"],
            "cache_hits": kinds["ooc_cache_hit"],
            "peak_bytes": peak, "base_bytes": base,
            "run_peak_bytes": peak - base,
            "host_syncs": n_syncs,
            "host_syncs_per_chunk": (n_syncs / chunks
                                     if n_syncs is not None and chunks
                                     else None),
            "sync_sites": sites[:8] if sites else sites}


def stream_profile(run, label, tries: int = 3) -> dict:
    """Device time and busy share of one warm run, summed from the
    profiler's raw device events (a streamed PageRank launches hundreds
    of thousands of kernels, and building the per-op tables over them
    took most of phase 13's time); taken again, up to
    ``tries`` times, while a kernel the run launched shows no device
    time.  ``run()`` returns (table, launches, load_s, query_s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _out, launches, load, query = run()
        by = collections.Counter()
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                by[e.name()] += (e.duration_ns() / 1e6
                                 if hasattr(e, "duration_ns")
                                 else e.duration_us() / 1e3)
        ours = {k: sum(v for n, v in by.items()
                       if any(s in n for s in subs))
                for k, subs in DEVICE_NAMES.items()}
        missing = [k for k, n in launches.items() if n and not ours[k]]
        if not missing:
            break
    if missing:
        raise AssertionError(f"{label}: {missing} launched but show no "
                             f"profiled device time in {tries} profiles")
    total = sum(by.values())
    return {"wall_s": load + query, "device_ms": total,
            "device_busy_share": total / 1e3 / (load + query),
            "port_kernels_ms": ours, "profile_takes": attempt + 1,
            "top": [[k[:120], v] for k, v in by.most_common(6)]}


def _line(r: dict, rows: int) -> dict:
    """A run's printable numbers (no table, no captured calls)."""
    line = {k: v for k, v in r.items() if k not in ("out", "captured")}
    line["rows_per_s"] = rows / r["wall_s"]
    return line


def stream_cell(port, hk, ooc, label, app, check, config, rows, held,
                device="cuda") -> dict:
    """A phase-13 cell: a cold run (its kernel calls held, its host syncs
    counted, its result checked), a warm run (wall, copies, peak memory,
    checked) and one profiled warm run (device busy share).  ``cell_s``:
    the seconds the cell took, holds and profile included."""
    t0 = time.perf_counter()
    steps = {}
    cold = stream_run(port, hk, ooc, app, config, device, capture=True,
                      syncs=True)
    must = STREAM_MUST[label.split("_")[0]]
    lc = cold["launches"]
    if any(lc[k] == 0 for k in must) or lc["slot_expand"] or \
            lc["slot_compact"]:
        raise AssertionError(f"{label}: launches {lc}, must launch {must} "
                             f"and no exchange kernel")
    t1 = time.perf_counter()
    held(label, lc, cold["captured"])
    steps["hold_s"] = time.perf_counter() - t1
    sizes = check(cold["out"])
    steps["cold_s"] = time.perf_counter() - t0
    warm = stream_run(port, hk, ooc, app, config, device)
    check(warm["out"])
    line = {"cold": _line(cold, rows), "warm": _line(warm, rows), **sizes}

    def profiled():
        r = stream_run(port, hk, ooc, app, config, device)
        return None, r["launches"], 0.0, r["wall_s"]
    t1 = time.perf_counter()
    if device == "cuda":
        line["profiled"] = stream_profile(profiled, label)
    steps["profile_s"] = time.perf_counter() - t1
    line["cell_s"] = time.perf_counter() - t0
    line["steps"] = steps
    return line, cold, warm


def terasort_ooc_runs(port, hk, ooc, ts, sizes, tmp, held,
                      device="cuda") -> dict:
    """terasortooc10m: TeraGen records written chunk by chunk, then
    ``read_store_stream(chunk_rows).order_by(key).to_store(out)``, read
    back and held (count, byte order, the input's multiset): ooc_inflight
    1 once, 2 cold / warm / profiled, the in-core tier once, the same
    depth-2 query at ``small_records`` (its peak device memory against the
    big run's), and the ``terasort_ooc`` app."""
    chunk = sizes.record_chunk
    src = os.path.join(tmp, "teragen")
    small = os.path.join(tmp, "teragen_small")
    out = os.path.join(tmp, "sorted")
    t0 = time.perf_counter()
    want = write_teragen(ooc, src, sizes.records, chunk)
    gen_s = time.perf_counter() - t0
    want_small = write_teragen(ooc, small, sizes.small_records, chunk)

    def query(path):
        def app(ctx):
            ctx.read_store_stream(path, chunk_rows=chunk).order_by(
                [("key", False)]).to_store(out)
            return read_sorted(ooc, out)
        return app

    def ooc_cfg(depth, incore=0):
        return port.JobConfig(ooc_inflight=depth, ooc_incore_bytes=incore)

    first = {}

    def check(got):
        # the first read-back is held to the input's multiset; later runs
        # must give the very same rows
        if not first:
            first.update(check_terasort_store("terasortooc10m", got, want))
            first["out"] = got
        elif not (np.array_equal(got[0], first["out"][0])
                  and np.array_equal(got[1], first["out"][1])):
            raise AssertionError("terasortooc10m: a run's rows differ from "
                                 "the first run's")
        return {"rows": first["rows"]}

    def sort_launches(label, r):
        """hist_buckets: one launch per chunk scattered (pass B and any
        re-bucketing), and no exchange kernel."""
        (s,) = r["sorts"]
        want_hist = s["scattered"] + s["rebucketed"]
        if r["launches"]["hist_buckets"] != want_hist or \
                r["launches"]["slot_expand"] or r["launches"]["slot_compact"]:
            raise AssertionError(
                f"{label}: launches {r['launches']} for {s}")
        return s

    res = {"records": sizes.records, "chunk_rows": chunk,
           "teragen_write_s": gen_s, "started_s": time.perf_counter()}
    line, cold, warm = stream_cell(port, hk, ooc, "terasortooc10m",
                                   query(src), check, ooc_cfg(2),
                                   sizes.records, held, device)
    res["depth2"] = {**line, "sort": sort_launches("terasortooc10m", cold)}
    scatter = scatter_hist_calls("terasortooc10m", cold.pop("captured"),
                                 (res["depth2"]["sort"]["n_buckets"],))
    sort_launches("terasortooc10m warm", warm)
    if res["depth2"]["sort"]["scattered"] != -(-sizes.records // chunk):
        raise AssertionError("terasortooc10m: pass B scattered "
                             f"{res['depth2']['sort']} chunks")
    d1 = stream_run(port, hk, ooc, query(src), ooc_cfg(1), device,
                    capture=True)
    held("terasortooc10m_depth1", d1["launches"], d1.pop("captured"))
    check(d1["out"])
    res["depth1"] = {**_line(d1, sizes.records),
                     "sort": sort_launches("terasortooc10m depth 1", d1)}
    inc = stream_run(port, hk, ooc, query(src), ooc_cfg(2, 1 << 30),
                     device)
    check(inc["out"])
    (s,) = inc["sorts"]
    if not s["incore"] or inc["launches"]["hist_buckets"]:
        raise AssertionError(f"terasortooc10m in-core: {s}, "
                             f"{inc['launches']}")
    res["incore"] = _line(inc, sizes.records)
    first.clear()
    want = want_small
    sm = stream_run(port, hk, ooc, query(small), ooc_cfg(2), device)
    check(sm["out"])
    sort_launches("terasortooc1m", sm)
    res["small"] = _line(sm, sizes.small_records)
    big, little = warm["run_peak_bytes"], sm["run_peak_bytes"]
    res["peak"] = {
        "records": [sizes.records, sizes.small_records],
        "peak_bytes": [warm["peak_bytes"], sm["peak_bytes"]],
        "run_peak_bytes": [big, little],
        "run_peak_bytes_per_chunk_row": [big / chunk, little / chunk],
        "ratio": big / max(little, 1), "limit": PEAK_RATIO}
    if device == "cuda" and not big <= PEAK_RATIO * little:
        raise AssertionError(f"terasortooc10m: peak device memory "
                             f"{res['peak']} grows with the data")
    # the app: records generated chunk by chunk inside external_sort
    app_out = os.path.join(tmp, "sorted_app")
    info = {}

    def app(ctx):
        ts.terasort_ooc(sizes.app_records, chunk, out_store=app_out,
                        device=device, info=info)
        return read_sorted(ooc, app_out)
    ar = stream_run(port, hk, ooc, app, None, device, capture=True)
    held("terasort_ooc2m", ar["launches"], ar.pop("captured"))
    keys = np.concatenate([teragen_chunk(i, min(chunk, sizes.app_records
                                                - i * chunk))[0]
                           for i in range(-(-sizes.app_records // chunk))])
    pays = np.concatenate([teragen_chunk(i, min(chunk, sizes.app_records
                                                - i * chunk))[1]
                           for i in range(-(-sizes.app_records // chunk))])
    check_terasort_store("terasort_ooc", ar["out"], (keys, pays))
    ar["sorts"] = [info]
    sort_launches("terasort_ooc", ar)
    res["app"] = {**_line(ar, sizes.app_records), "sort": info}
    for p in (src, small, out, app_out):
        shutil.rmtree(p, ignore_errors=True)
    res["cell_s"] = time.perf_counter() - res.pop("started_s")
    return res, scatter


def scatter_hist_calls(label, captured, n_buckets_of) -> dict:
    """Per (ids, B) shape at a wanted bucket count, out of a run's
    captured ``hist_buckets`` calls: one call and the number of calls at
    that shape."""
    out = {}
    for _size, args in captured.get("hist_buckets", []):
        bid, nb = args
        if nb in n_buckets_of:
            ent = out.setdefault((label, bid.shape[1], nb),
                                 {"args": args, "calls": 0})
            ent["calls"] += 1
    return out


def scatter_hist_rows(hk, scatter, card) -> list:
    """The streamed scatter's histogram at its shapes (one id row of a
    whole chunk: the sort's 262,144 ids at B = 78 range buckets,
    PageRank's joined 262,144-row chunks and k-means' 65,536 at B = 64
    hash buckets): the kernel, its plain version and ``bincount`` (CUDA
    events, ms per call over 20 calls), the device kernels a call runs
    (the route: ``hist_shared`` past 32 buckets, after a memset of the
    counts), and the bound (each id read once, each count written once,
    over the memory rate)."""
    rows = []
    for (label, _n, nb), ent in sorted(scatter.items()):
        args = ent["args"]
        wrapper, plain = fns(hk, "hist_buckets")
        nbytes, ops = work("hist_buckets", args)
        for _ in range(3):    # a profiler window may record no event
            names = sorted({k[:40] for k, _c, _us in profile_window(
                lambda: wrapper(*args))})
            if any(n in k for k in names
                   for n in DEVICE_NAMES["hist_buckets"]):
                break
        rows.append({
            "run": label, "ids": list(args[0].shape), "n_buckets": nb,
            "calls_in_run": ent["calls"],
            "ms": cuda_ms(lambda: wrapper(*args)),
            "plain_ms": cuda_ms(lambda: plain(*args)),
            "library_ms": cuda_ms(library_call("hist_buckets", args)),
            "bound_ms": max(nbytes / PEAK_BYTES_PER_S,
                            ops / PEAK_OPS_PER_S) * 1e3,
            "bound_by": ("bytes" if nbytes / PEAK_BYTES_PER_S
                         >= ops / PEAK_OPS_PER_S else "operations"),
            "device_kernels": names, "card": card})
    return rows


def phase13_runs(port, hk, sizes, tmp, lines, want_counts, held,
                 device="cuda") -> dict:
    """Phase 13's runs through the public streamed entry points, each
    held to its oracle (see the module docstring).  Stores and files live
    under ``tmp`` and are deleted.  Returns one line per cell, and under
    ``"scatter_calls"`` one captured scatter histogram per (run, ids,
    buckets): the sort's range scatter, PageRank's and k-means' hash
    scatters."""
    from dryad_tpu_torch.apps import kmeans as km
    from dryad_tpu_torch.apps import pagerank as pr
    from dryad_tpu_torch.apps import terasort as ts
    from dryad_tpu_torch.exec import ooc
    tera, scatter = terasort_ooc_runs(port, hk, ooc, ts, sizes, tmp,
                                      held, device)
    res = {"terasortooc10m": tera}
    chunk = sizes.stream_chunk

    def store_of(name, cols):
        path = os.path.join(tmp, name)
        src = ooc.ChunkSource.from_arrays(cols, chunk)
        ooc.write_chunks_to_store(path, iter(src), src.schema)
        return path

    # PageRank over a cached edge stream
    n_edges = PR_EDGES * sizes.nodes // 100_000
    edges = pr.gen_graph(sizes.nodes, n_edges, seed=0)
    epath = store_of("edges", edges)
    cache_dir = os.path.join(tmp, "cache")
    cfg = port.JobConfig(ooc_cache_dir=cache_dir)

    def pagerank(ctx):
        return pr.pagerank_stream(ctx, ctx.read_store_stream(
            epath, chunk_rows=chunk).cache(), sizes.nodes,
            n_iters=PR_ITERS)

    # the float64 references, computed once for the cell's three checks
    pr_ref = types.SimpleNamespace(pagerank_numpy=lambda *_a, _r=(
        pr.pagerank_numpy(edges, sizes.nodes, PR_ITERS)): _r)
    line, cold, warm = stream_cell(
        port, hk, ooc, "pagerankstream100k", pagerank,
        lambda out: check_pagerank(out, edges, sizes.nodes, pr_ref), cfg,
        len(edges["src"]) * PR_ITERS, held, device)
    scatter.update(scatter_hist_calls("pagerankstream100k",
                                      cold.pop("captured"), (64,)))
    # the cold run writes the edges' entry and the out-degrees' once;
    # every pass of every superstep re-streams them
    if cold["cache_writes"] != 2 or warm["cache_writes"] or \
            min(cold["cache_hits"], warm["cache_hits"]) < 2 * PR_ITERS:
        raise AssertionError(f"pagerankstream100k: cache events cold "
                             f"{cold['cache_writes']} writes / "
                             f"{cold['cache_hits']} hits, warm "
                             f"{warm['cache_writes']} / "
                             f"{warm['cache_hits']}")
    res["pagerankstream100k"] = {"edges": len(edges["src"]),
                                 "iters": PR_ITERS, "chunk_rows": chunk,
                                 **line}
    shutil.rmtree(cache_dir, ignore_errors=True)

    # k-means over a point stream
    pts, _ = km.gen_points(sizes.points, KM_DIM, KM_K, seed=0)
    ppath = store_of("points", pts)
    init = np.asarray(pts["x"])[:KM_K].copy()
    km_ref = types.SimpleNamespace(kmeans_numpy=lambda *_a, _r=(
        km.kmeans_numpy(pts, KM_K, KM_ITERS)): _r)
    line, cold, _ = stream_cell(
        port, hk, ooc, "kmeansstream500k",
        lambda ctx: km.kmeans_stream(ctx, ctx.read_store_stream(
            ppath, chunk_rows=sizes.point_chunk), KM_K, init,
            n_iters=KM_ITERS),
        lambda out: check_kmeans(out, pts, km_ref), None,
        sizes.points * KM_ITERS, held, device)
    scatter.update(scatter_hist_calls("kmeansstream500k",
                                      cold.pop("captured"), (64,)))
    res["kmeansstream500k"] = {"chunk_rows": sizes.point_chunk, **line}

    # TPC-H Q13's shape: the orders streamed, the customers the
    # materialized side of a right and a full join, orders per customer
    _li, orders, cust = tpch_tables(sizes.lineitems)
    del _li
    opath = store_of("orders", orders)
    n_cust = len(cust["custkey"])
    n_per, _s, _b = _per_customer(orders, np.ones(len(orders["okey"]),
                                                  bool), n_cust)

    def q13(how):
        def app(ctx):
            return (ctx.read_store_stream(opath, chunk_rows=chunk)
                    .select(_q13_hit)
                    .join(ctx.from_columns(cust), ["custkey"], how=how)
                    .group_by(["custkey"], {"n": ("sum", "hit"),
                                            "rows": ("count", None)})
                    .collect())
        return app

    def check_q13_stream(out):
        o = np.argsort(out["custkey"])
        k = np.asarray(out["custkey"])[o]
        n = np.asarray(out["n"])[o]
        if not (np.array_equal(k, cust["custkey"])
                and np.array_equal(n, n_per[k])
                and np.array_equal(np.asarray(out["rows"])[o],
                                   np.maximum(n_per[k], 1))):
            raise AssertionError("q13stream1m5: orders per customer differ "
                                 "from numpy")
        return {"customers": n_cust, "orders": len(orders["okey"]),
                "unmatched_customers": int((n == 0).sum())}

    res["q13stream1m5"] = {}
    for how in ("right", "full"):
        line, _, _ = stream_cell(
            port, hk, ooc, f"q13stream1m5_{how}", q13(how),
            check_q13_stream, None, len(orders["okey"]), held,
            device)
        if line["unmatched_customers"] != n_cust - len(
                np.unique(orders["custkey"])):
            raise AssertionError("q13stream1m5: customers with no order "
                                 "missing")
        res["q13stream1m5"][how] = line

    # WordCount over a text stream
    tpath = os.path.join(tmp, "bench12.txt")
    with open(tpath, "w") as f:
        f.write("\n".join(lines) + "\n")

    def wordcount(ctx):
        return (ctx.read_text_stream(tpath, chunk_rows=sizes.text_chunk,
                                     max_line_len=96)
                .split_words("line", out_capacity=sizes.text_chunk * 10,
                             lower=True)
                .group_by(["line"], {"n": ("count", None)}).collect())

    def check_wc(out):
        got = dict(zip(out["line"], (int(v) for v in out["n"])))
        if got != want_counts:
            raise AssertionError("readtextstream1m: counts differ from "
                                 "phase 3's")
        return {"lines": len(lines), "words": len(got)}

    line, _, _ = stream_cell(port, hk, ooc, "readtextstream1m", wordcount,
                             check_wc, None, len(lines), held,
                             device)
    res["readtextstream1m"] = line
    res["scatter_calls"] = scatter
    for name in ("edges", "points", "orders", "bench12.txt"):
        p = os.path.join(tmp, name)
        shutil.rmtree(p, ignore_errors=True) if os.path.isdir(p) \
            else os.remove(p)
    return res


def _q13_hit(c):
    """The orders' columns plus ``hit`` = 1: summed per customer it counts
    the customer's orders (0 for a customer no order matched, whose row
    the right / full join synthesizes)."""
    import torch
    return dict(c, hit=torch.ones_like(c["okey"]))


# ---------------------------------------------------------------------------
# phase 14: the SQL front end on the card

# bench.py:370-374's skewed TPC-H-style query (the hot order key passes
# its filter), the two committed golden queries, a Q1-shaped aggregate
SQL_Q3 = ("SELECT l.okey, SUM(l.price * l.qty) AS revenue, COUNT(*) AS n "
          "FROM lineitem l JOIN orders o ON l.okey = o.okey "
          "WHERE o.flag = 0 GROUP BY l.okey ORDER BY revenue DESC LIMIT 10")
SQL_Q1 = ("SELECT qty, COUNT(*) AS n, SUM(price) AS s, AVG(price) AS a, "
          "MIN(price) AS lo, MAX(price) AS hi FROM lineitem "
          "WHERE tag != 'void' GROUP BY qty ORDER BY qty")
SQL_GOLDEN = ("sql_join_revenue", "sql_scan_topk")
SQL_WARM_REPS = 3      # sqlq3's interleaved warm runs (bench.py:385-394)
_COST_ROW = re.compile(r"^\s*(\d+)\s+(\S+)\s+(\d+)\s")


def sql_tables(n_items: int):
    """``tpch_tables(n_items)``'s lineitem with ``price`` cast to float32
    (as docs/plans/sql_catalog.json declares it: an int32 SUM(price * qty)
    wraps past 2^31 on the hot key) and a ``tag`` string column,
    ``b"void"`` on every third row, else ``b"ok"`` (tests/test_sql.py's
    catalog); its orders' ``okey`` and ``flag``."""
    li, orders, _ = tpch_tables(n_items)
    li["price"] = li["price"].astype(np.float32)
    li["tag"] = ([b"void", b"ok", b"ok"] * (n_items // 3 + 1))[:n_items]
    return li, {"okey": orders["okey"], "flag": orders["flag"]}


def revenue_oracle(li, flag: int):
    """Per order key whose order has ``flag`` (flag = okey % 2, and every
    lineitem's key names an order): SUM(price * qty) in float64, the row
    count and the sum of |price * qty| (the f32 bound's scale)."""
    keep = li["okey"] % 2 == flag
    ok = li["okey"][keep]
    v = li["price"][keep].astype(np.float64) * li["qty"][keep]
    nb = int(li["okey"].max()) + 1
    return (np.bincount(ok, weights=v, minlength=nb),
            np.bincount(ok, minlength=nb),
            np.bincount(ok, weights=np.abs(v), minlength=nb))


def check_topk_revenue(label, out, li, flag: int, k: int = 10) -> dict:
    """ORDER BY revenue DESC LIMIT k against the oracle, ties allowed:
    k distinct keys in descending order, each key's count exact and its
    revenue within 16 eps sum|v| of the oracle's (PERF.md §2), and the
    smallest revenue returned at least the oracle's k-th less that bound
    (f32 sums differ in their last bits between packages and runs)."""
    rev, cnt, absum = revenue_oracle(li, flag)
    keys = np.asarray(out["okey"], np.int64)
    got = np.asarray(out["revenue"], np.float64)
    present = np.nonzero(cnt)[0]
    kk = min(k, len(present))
    tol = 16 * EPS * absum[keys] if len(keys) else np.zeros(0)
    kth = np.sort(rev[present])[::-1][kk - 1]
    kth_tol = 16 * EPS * float(absum[present][rev[present] == kth].max())
    if (len(keys) != kk or len(set(keys.tolist())) != kk
            or not np.array_equal(np.asarray(out["n"]), cnt[keys])
            or not (np.abs(got - rev[keys]) <= tol).all()
            or (np.diff(got) > 0).any() or got.min() < kth - kth_tol):
        raise AssertionError(f"{label}: the top {k} revenues differ from "
                             f"the oracle's: {list(zip(keys, got))}")
    return {"rows": kk, "max_revenue": float(got[0]),
            "max_rel_err": float((np.abs(got - rev[keys])
                                  / np.maximum(rev[keys], 1)).max())}


def check_scan_topk(label, out, li, k: int = 100) -> dict:
    """sql_scan_topk: the k prices equal the oracle's top k exactly (f32
    integral values), in descending order, and every returned
    (okey, price, qty) is a qualifying row, no more often than the input
    holds it."""
    mask = (li["qty"] > 2) & (np.arange(len(li["qty"])) % 3 != 0)
    want = np.sort(li["price"][mask])[::-1][:k]
    got = np.asarray(out["price"])
    if not np.array_equal(got, want):
        raise AssertionError(f"{label}: prices differ from the oracle's "
                             f"top {k}")
    sel = mask & (li["price"] >= got.min())
    have = collections.Counter(zip(li["okey"][sel].tolist(),
                                   li["price"][sel].tolist(),
                                   li["qty"][sel].tolist()))
    rows = collections.Counter(zip(np.asarray(out["okey"]).tolist(),
                                   got.tolist(),
                                   np.asarray(out["qty"]).tolist()))
    if any(n > have[r] for r, n in rows.items()):
        raise AssertionError(f"{label}: a returned row is not a "
                             f"qualifying input row")
    return {"rows": len(got), "qualifying": int(mask.sum())}


def check_q1agg(label, out, li) -> dict:
    """SQL_Q1 against numpy: the qty keys in order and the counts, MIN and
    MAX exactly; SUM within 16 eps sum|v| of the float64 sum, AVG within
    that over the count."""
    mask = np.arange(len(li["qty"])) % 3 != 0
    q, p = li["qty"][mask], li["price"][mask]
    keys = np.unique(q)
    n = np.bincount(q)[keys]
    s = np.bincount(q, weights=p.astype(np.float64))[keys]
    tol = 16 * EPS * s                       # prices are positive
    lo = np.array([p[q == x].min() for x in keys])
    hi = np.array([p[q == x].max() for x in keys])
    ok = (np.array_equal(np.asarray(out["qty"]), keys)
          and np.array_equal(np.asarray(out["n"]), n)
          and np.array_equal(np.asarray(out["lo"]), lo)
          and np.array_equal(np.asarray(out["hi"]), hi)
          and (np.abs(np.asarray(out["s"], np.float64) - s) <= tol).all()
          and (np.abs(np.asarray(out["a"], np.float64) - s / n)
               <= tol / n).all())
    if not ok:
        raise AssertionError(f"{label}: the aggregate differs from numpy")
    return {"rows": len(keys), "qualifying": int(mask.sum())}


def sql_events(label, ev) -> dict:
    """A SQL run's events (lint "warn"): no error-severity lint_finding,
    one cost_report, no cost_model_miss, and one plan event whose JSON
    round-trips through graph_from_json -> graph_to_json byte for byte
    (the row expressions rebuild from data, no fn_table) with the stage
    ids of the run's stage events (an adaptive rewrite may append
    stages)."""
    from dryad_tpu_torch.plan.serialize import graph_from_json, \
        graph_to_json
    kinds = collections.Counter(e["event"] for e in ev)
    for m in (e for e in ev if e["event"] == "cost_model_miss"):
        print(f"cost_model_miss {label}: stage {m['stage']} "
              f"({m['label']}) {m['what']} measured {m['measured']} "
              f"predicted {m['predicted']}", flush=True)
    errors = [e for e in ev if e["event"] == "lint_finding"
              and e["severity"] == "error"]
    plans = [e["plan"] for e in ev if e["event"] == "plan"]
    if (errors or kinds["cost_report"] != 1 or kinds["cost_model_miss"]
            or len(plans) != 1):
        raise AssertionError(
            f"{label}: lint errors {errors}, {kinds['cost_report']} "
            f"cost_report, {kinds['cost_model_miss']} cost_model_miss, "
            f"{len(plans)} plan events")
    d = json.loads(plans[0])
    slots = {f"{st['id']}:{i}": None for st in d["stages"]
             for i, leg in enumerate(st["legs"]) if "source" in leg["src"]}
    graph = graph_from_json(plans[0], fn_table={}, sources=slots)
    ids = {st.id for st in graph.stages}
    done = {e["stage"] for e in ev if e["event"] == "stage_done"}
    if (graph_to_json(graph) != plans[0] or not done & ids
            or (done - ids and not kinds["graph_rewrite"])):
        raise AssertionError(f"{label}: the plan event does not round-trip "
                             f"or name the run's stages ({sorted(ids)} "
                             f"against {sorted(done)})")
    return {"lint": sorted({e["code"] for e in ev
                            if e["event"] == "lint_finding"}),
            "plan_stages": len(ids), "stages_done": sorted(done),
            "cost_report": [s["capacity"] for s in next(
                e for e in ev if e["event"] == "cost_report")
                ["report"]["stages"]]}


def sql_explain_cost(label, hk, sql, ctx, cat, text, plan_json,
                     run_caps) -> dict:
    """``EXPLAIN COST`` through ``sql.explain`` on the card context: no
    kernel launches (the counters stand still), no DTA error, and the
    predicted capacities those of the executed plan: stage for stage the
    cold run's cost report, and the plan's structural capacities
    (``estimate_plan_json``) where the plan states them."""
    import torch
    from dryad_tpu_torch.analysis.cost import estimate_plan_json
    before = dict(hk.launches)
    from_columns, load = ctx.from_columns, [0.0]

    def timed_from_columns(*args, **kw):
        t0 = time.perf_counter()
        ds = from_columns(*args, **kw)
        torch.cuda.synchronize()
        load[0] += time.perf_counter() - t0
        return ds

    ctx.from_columns = timed_from_columns
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text_out = sql.explain(ctx, cat, "EXPLAIN COST " + text)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        del ctx.from_columns
    table = text_out.split("predicted cost:\n", 1)[-1]
    caps = [int(m.group(3)) for m in map(_COST_ROW.match,
                                         table.splitlines()[1:]) if m]
    structural = [s.capacity for s in
                  estimate_plan_json(plan_json, NPARTS).stages]
    if (dict(hk.launches) != before
            or not re.search(r"^0 error\(s\)", text_out, re.M)
            or caps != run_caps
            or any(s and s != c for s, c in zip(structural, caps))):
        raise AssertionError(f"{label}: EXPLAIN COST launched "
                             f"{dict(hk.launches)} (from {before}), or its "
                             f"capacities {caps} are not the run's "
                             f"{run_caps} / the plan's {structural}:\n"
                             f"{text_out}")
    return {"explain_cost_s": secs, "explain_cost_load_s": load[0],
            "capacities": caps, "structural": structural}


def sql_cell(port, hk, sql, cat, label, text, check, held,
             adaptive: str = "off", warm: int = 1):
    """One phase-14 cell under ``JobConfig(lint="warn", adaptive=...)``
    in a context of its own: the cold run (``sql.query -> collect``
    through ``run_app``: kernel calls held, launches against the
    executor's log, rows against the oracle, events by ``sql_events``),
    then ``warm`` warm runs (walls; rows against the oracle), then EXPLAIN
    COST.  Returns (line, context, the cold run's rows)."""
    from dryad_tpu_torch.utils.events import EventLog
    log = EventLog()
    ctx = port.Context(device="cuda", nparts=NPARTS, event_log=log,
                       config=port.JobConfig(lint="warn",
                                             adaptive=adaptive))
    app = (lambda c: sql.query(c, cat, text).collect())
    hk.capture = {}
    out, launches, load, qs, runs = run_app(port, hk, app, ctx=ctx)
    captured, hk.capture = hk.capture, None
    held(label, launches, captured)
    del captured
    stages = loop_stages(runs)
    check_per_exchange(label, launches, stages["exchange_attempts"],
                       stages["broadcast_attempts"], stages["probes"])
    sizes = check(label, out)
    ev = sql_events(label, log.events)
    line = {**sizes, "nparts": NPARTS, "adaptive": adaptive,
            "launches": launches, "exchanging_stages": stages["outside_loop"],
            "exchange_attempts": stages["exchange_attempts"],
            "rewrites": [e.get("kind") for e in log.of_type(
                "graph_rewrite")],
            "cold_wall_s": load + qs, "cold_load_s": load,
            "cold_query_s": qs, **{k: v for k, v in ev.items()
                                   if k != "cost_report"}}
    plan_json = next(e["plan"] for e in log.events if e["event"] == "plan")
    line["warm"] = [sql_warm(port, hk, app, ctx, check, label)
                    for _ in range(warm)]
    line.update(sql_explain_cost(label, hk, sql, ctx, cat, text, plan_json,
                                 ev["cost_report"]))
    return line, ctx, out


def sql_warm(port, hk, app, ctx, check, label) -> dict:
    """One warm run in the cold run's context: walls, the pre-submit
    gate's share of the query (``lint_s``: the plan rules, the UDF lint
    and the cost model), rows held to the oracle."""
    gate, spent = ctx._pre_submit_lint, [0.0]

    def timed_gate(*args, **kw):
        t0 = time.perf_counter()
        try:
            return gate(*args, **kw)
        finally:
            spent[0] += time.perf_counter() - t0

    ctx._pre_submit_lint = timed_gate
    try:
        out, _launches, load, qs, _runs = run_app(port, hk, app, ctx=ctx)
    finally:
        del ctx._pre_submit_lint
    check(label, out)
    return {"wall_s": load + qs, "load_s": load, "query_s": qs,
            "lint_s": spent[0]}


def sql_catalog(port_sql, n_items: int):
    """(lineitem, orders, a ``sql.Catalog`` holding both) over
    ``sql_tables(n_items)``."""
    li, orders = sql_tables(n_items)
    cat = port_sql.Catalog()
    cat.register_columns("lineitem", li)
    cat.register_columns("orders", orders)
    return li, orders, cat


def phase14_runs(port, hk, n_items: int, held, out_dir=None,
                 tables=None) -> dict:
    """Phase 14's cells over ``sql_tables(n_items)`` registered in a
    ``sql.Catalog`` (``tables``: ``sql_catalog``'s triple, made here when
    None): sqlq3_6m adaptive off and on (cold each, then
    ``SQL_WARM_REPS`` warm runs of each in turns, off first, then, with
    ``out_dir``, one profiled warm run of each: device time and busy
    share), the two committed golden queries and the Q1-shaped aggregate
    (cold, one warm run).  Every cell under lint "warn", its EXPLAIN
    COST launch-free."""
    from dryad_tpu_torch import sql
    li, orders, cat = tables or sql_catalog(sql, n_items)
    res = {}

    def q3_check(label, out):
        return check_topk_revenue(label, out, li, flag=0)

    def q3_app(c):
        return sql.query(c, cat, SQL_Q3).collect()

    cells, outs = {}, {}
    for mode in ("off", "on"):
        line, ctx, outs[mode] = sql_cell(
            port, hk, sql, cat, f"sqlq3_6m_{mode}", SQL_Q3, q3_check, held,
            adaptive=mode, warm=0)
        cells[mode] = (line, ctx)
    walls = collections.defaultdict(list)
    for mode in ("off", "on") * SQL_WARM_REPS:
        walls[mode].append(sql_warm(port, hk, q3_app, cells[mode][1],
                                    q3_check, f"sqlq3_6m_{mode}"))
    for mode in ("off", "on"):
        line, ctx = cells[mode]
        line["warm"] = walls[mode]
        w = sorted(x["wall_s"] for x in walls[mode])
        line["warm_wall_median_s"] = w[len(w) // 2]
        if out_dir is not None:
            prof = profile_path(
                lambda: run_app(port, hk, q3_app, ctx=ctx)[:4],
                f"sqlq3_6m_{mode}", out_dir, pack=False)
            line.update({"profiled_wall_s": prof["wall_s"],
                         "profiled_device_ms": prof["device_ms"],
                         "device_busy_share": prof.get("device_busy_share"),
                         "port_kernels_ms": prof.get("port_kernels_ms"),
                         "top": prof.get("top")})
        res[f"sqlq3_6m_{mode}"] = line
    res["sqlq3_6m_on"]["rows_equal_off"] = (_row_set(outs["on"])
                                            == _row_set(outs["off"]))
    del outs, cells
    plans = os.path.join(HERE, "docs", "plans")
    golden = {"sql_join_revenue": lambda label, out:
              check_topk_revenue(label, out, li, flag=1),
              "sql_scan_topk": lambda label, out:
              check_scan_topk(label, out, li)}
    for name, label in zip(SQL_GOLDEN, ("sqlgolden_join6m",
                                        "sqlgolden_scan6m")):
        with open(os.path.join(plans, name + ".sql")) as f:
            text = f.read()
        res[label] = sql_cell(port, hk, sql, cat, label, text, golden[name],
                              held)[0]
    res["sqlq1agg6m"] = sql_cell(
        port, hk, sql, cat, "sqlq1agg6m", SQL_Q1,
        lambda label, out: check_q1agg(label, out, li), held)[0]
    return res


# ---------------------------------------------------------------------------
# phase 15: observability on the card

OBS_REPS = 3             # warm PageRank runs with telemetry off and on each
OBS_SAMPLE_S = 0.1       # the telemetry-on runs' resource sampler period
OBS_CLI = ("trace", "critical-path", "metrics", "analyze", "history")
# the Chrome trace categories of device records
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def obs_sqlq3(port, hk, sql, cat, held, device="cuda") -> dict:
    """obs_sqlq3_6m: ``sql.explain(ctx, cat, "EXPLAIN ANALYZE " + SQL_Q3)``
    (adaptive off, lint off: ANALYZE runs the cost model itself) in a
    context with an event log, through ``run_app`` (kernel calls held,
    launches against the executor's log).  The report (the log's
    ``analyze_report``) against the run's own capture (the event log the
    executor ran with): each settled stage's rows equal to the rows its
    last settled ``stage_done`` carries, every settled stage at scale 1
    inside its predicted rows, and inside its predicted bytes where every
    stage upstream of it (by the run's ``plan`` event) ran at scale 1 as
    well; zero ``cost_model_miss``; and the join stage's unsalted retry
    (2 runs, 1 retry).  A stage downstream of the rescaled join may carry
    the join's larger capacity, so its exact byte prediction (made for
    planned capacities) does not apply; the runtime cross-check skips it
    too, and the line lists such stages (``bytes_on_rescaled_input``)."""
    from dryad_tpu_torch.utils.events import EventLog
    log = EventLog()
    ctx = port.Context(device=device, nparts=NPARTS, event_log=log)
    caps, run = [], ctx.executor.run

    def recording_run(graph, bindings=None, **kw):
        caps.append(kw.get("event_log"))
        return run(graph, bindings, **kw)

    # run_app wraps this and removes both wrappers when it returns
    ctx.executor.run = recording_run
    hk.capture = {}
    text, launches, load, qs, runs = run_app(
        port, hk, lambda c: sql.explain(c, cat, "EXPLAIN ANALYZE " + SQL_Q3),
        device, ctx=ctx)
    captured, hk.capture = hk.capture, None
    held("obs_sqlq3_6m", launches, captured)
    del captured
    stages = loop_stages(runs)
    check_per_exchange("obs_sqlq3_6m", launches,
                       stages["exchange_attempts"],
                       stages["broadcast_attempts"], stages["probes"])
    (rep,) = [e["report"] for e in log.of_type("analyze_report")]
    (cap,) = caps
    done = {}
    for e in cap.of_type("stage_done"):
        if not e["overflow"]:
            done[e["stage"]] = e
    misses = cap.of_type("cost_model_miss")
    settled = [st for st in rep["stages"] if st["settled"]]
    bad = [st["stage"] for st in settled
           if st["rows"] != sum(done[st["stage"]]["rows"])
           or st["out_bytes"] != done[st["stage"]]["out_bytes"]]
    (plan,) = [json.loads(e["plan"]) for e in cap.of_type("plan")]
    ups = {st["id"]: [leg["src"]["stage"] for leg in st["legs"]
                      if "stage" in leg["src"]] for st in plan["stages"]}
    scale = {st["stage"]: st["scale"] for st in rep["stages"]}

    def planned(sid):
        return scale[sid] == 1 and all(planned(u) for u in ups[sid])

    checked = [st for st in settled
               if st["scale"] == 1 and st["pred_rows"] is not None]
    unbounded = [st["stage"] for st in checked if not st["rows_in_bounds"]
                 or (planned(st["stage"]) and not st["bytes_in_bounds"])]
    rescaled_input = [st["stage"] for st in checked
                      if not planned(st["stage"])]
    checked = [st["stage"] for st in checked]
    (join,) = [st for st in rep["stages"] if st["label"] == "join"]
    if (bad or unbounded or not checked or misses or rep["misses"]
            or not rep["predicted"]
            or len(settled) != len(rep["stages"])
            or (join["runs"], join["retries"]) != (2, 1)
            or "EXPLAIN ANALYZE (executed):" not in text):
        raise AssertionError(
            f"obs_sqlq3_6m: rows differ from stage_done at {bad}, outside "
            f"the prediction at {unbounded}, {len(misses)} misses, join "
            f"{join['runs']} runs / {join['retries']} retries:\n{text}")
    return {"nparts": NPARTS, "launches": launches,
            "exchanging_stages": stages["outside_loop"],
            "exchange_attempts": stages["exchange_attempts"],
            "wall_s": load + qs, "load_s": load, "query_s": qs,
            "report_wall_s": rep["wall_s"], "report_run_s": rep["run_s"],
            "report_compile_s": rep["compile_s"],
            "cost_model_miss": len(misses), "checked_stages": checked,
            "bytes_on_rescaled_input": rescaled_input,
            "stages": [{k: st[k] for k in (
                "stage", "label", "runs", "retries", "rows", "out_bytes",
                "pred_rows", "pred_bytes", "rows_in_bounds",
                "bytes_in_bounds", "scale", "wall_s", "compile_s")}
                for st in rep["stages"]]}


def check_telemetry(label, log, runs, device) -> dict:
    """One telemetry-on run's events: per executor run one ``run`` job
    span, and a ``stage`` span for each stage the run computed, every
    one parented to that job span; one ``job_done`` per run carrying the
    job span's trace id and the metrics snapshot; at least one
    ``resource_sample``, with ``0 < device_bytes <=
    torch.cuda.max_memory_allocated()`` on the card; and the critical
    path of each run's spans covering its job span's wall (segments
    summing to it)."""
    import torch

    from dryad_tpu_torch.obs.critical_path import critical_path
    spans = log.of_type("span")
    jobs = [s for s in spans if s["kind"] == "job"]
    done = log.of_type("job_done")
    errors = []
    if len(jobs) != len(runs) or len(done) != len(runs):
        errors.append(f"{len(jobs)} job spans and {len(done)} job_done for "
                      f"{len(runs)} runs")
    worst = 0.0
    for job, r, d in zip(jobs, runs, done):
        mine = [s for s in spans if s["trace"] == job["trace"]]
        st = [s for s in mine if s["kind"] == "stage"]
        if (len(mine) != len(st) + 1
                or any(s.get("parent") != job["span"] for s in st)
                or {s["attrs"]["stage"] for s in st}
                != {e["stage"] for e in r["stages"]}):
            errors.append(f"run {job['trace']}: stage spans "
                          f"{[s['name'] for s in st]}")
        if d.get("trace") != job["trace"] or not d.get("metrics"):
            errors.append(f"job_done {d.get('trace')} for {job['trace']}")
        cp = critical_path(mine)
        seg = sum(x["self_s"] for x in cp["segments"])
        worst = max(worst, abs(cp["total_s"] - job["dur_s"]),
                    abs(seg - cp["total_s"]))
    if worst > 1e-5:
        errors.append(f"critical path off its job span's wall by {worst}")
    samples = log.of_type("resource_sample")
    dev = [e["device_bytes"] for e in samples if "device_bytes" in e]
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if not samples or (device == "cuda" and (
            len(dev) != len(samples) or not all(0 < b <= peak
                                                for b in dev))) or (
            device != "cuda" and dev):
        errors.append(f"{len(samples)} samples, device_bytes {dev[:4]}..., "
                      f"peak {peak}")
    if errors:
        raise AssertionError(f"{label}: " + "; ".join(errors))
    return {"job_spans": len(jobs), "stage_spans": sum(
        s["kind"] == "stage" for s in spans), "job_done": len(done),
        "samples": len(samples), "device_bytes_max": max(dev, default=None),
        "max_memory_allocated": peak, "critical_path_off_s": worst}


def obs_cli(history, events_path, out_dir) -> dict:
    """``python -m dryad_tpu_torch.obs`` trace / critical-path / metrics /
    analyze on one archived job's events.jsonl and history on the
    directory, each in its own process, all started together; each must
    exit 0 with output.  Returns {subcommand: seconds}."""
    args = {"trace": [events_path, "-o", os.path.join(out_dir,
                                                      "trace.json")],
            "critical-path": [events_path, "--json"],
            "metrics": [events_path], "analyze": [events_path, "--json"],
            "history": [history]}
    t0 = time.perf_counter()
    procs = {c: subprocess.Popen(
        [sys.executable, "-m", "dryad_tpu_torch.obs", c, *args[c]],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for c in OBS_CLI}
    out, bad = {}, {}
    for c, proc in procs.items():
        so, se = proc.communicate(timeout=300)
        out[c] = time.perf_counter() - t0
        if proc.returncode != 0 or not so.strip():
            bad[c] = (proc.returncode, se[-2000:])
    if bad:
        raise AssertionError(f"obs CLI: {bad}")
    return out


def obs_pagerank(port, hk, pr, edges, n_nodes, out_dir, held,
                 device="cuda") -> dict:
    """obs_pagerank100k: PageRank (``PR_ITERS`` supersteps) ``OBS_REPS``
    times each way in turns, off first, each in a new context: telemetry
    off (no event log) and on (``EventLog(level=2,
    history_dir=<out_dir>/history, app="pagerank")``,
    ``JobConfig(resource_sample_s=OBS_SAMPLE_S)``).  Every run's kernel
    calls held and launches checked; the ranks bit-equal across every
    run (the path is deterministic) and within PR_RTOL of
    ``pagerank_numpy``; ``Executor.host_reads`` equal on and off (the
    telemetry reads nothing back from the card); ``check_telemetry`` on
    each on run; the history directory's three archives with their four
    files; the obs CLI on the last archive; no sampler thread left
    behind.  Returns (line, the off runs' ranks)."""
    import threading

    from dryad_tpu_torch.utils.events import EventLog
    history = os.path.join(out_dir, "history")

    def app(c):
        return pr.pagerank(c, edges, n_nodes, n_iters=PR_ITERS)

    threads = threading.active_count()
    walls, reads, tele = (collections.defaultdict(list) for _ in range(3))
    ranks = None
    for i, mode in enumerate(("off", "on") * OBS_REPS):
        log = (EventLog(level=2, history_dir=history, app="pagerank")
               if mode == "on" else None)
        ctx = port.Context(device=device, nparts=NPARTS, event_log=log,
                           config=port.JobConfig(
                               resource_sample_s=OBS_SAMPLE_S))
        label = f"obs_pagerank100k_{mode}{i // 2}"
        hk.capture = {}
        out, launches, load, qs, runs = run_app(port, hk, app, device,
                                                ctx=ctx)
        captured, hk.capture = hk.capture, None
        held(label, launches, captured)
        del captured
        stages = loop_stages(runs)
        check_per_exchange(label, launches, stages["exchange_attempts"],
                           probes=stages["probes"])
        sizes = check_pagerank(out, edges, n_nodes, pr)
        r = np.asarray(out["rank"])[np.argsort(out["node"])]
        if ranks is None:
            ranks = r
        elif r.tobytes() != ranks.tobytes():
            raise AssertionError(f"{label}: ranks differ from the first "
                                 f"off run's")
        walls[mode].append(load + qs)
        reads[mode].append(ctx.executor.host_reads)
        if log is not None:
            log.close()
            tele[mode].append(check_telemetry(label, log, runs, device))
    if threading.active_count() != threads:
        raise AssertionError(f"obs_pagerank100k: {threading.active_count()} "
                             f"threads after the runs, {threads} before")
    if len(set(reads["off"] + reads["on"])) != 1:
        raise AssertionError(f"obs_pagerank100k: host reads off "
                             f"{reads['off']}, on {reads['on']}")
    jobs = sorted(os.listdir(history))
    files = {j: sorted(os.listdir(os.path.join(history, j))) for j in jobs}
    want = ["events.jsonl", "metrics.json", "plan.json", "summary.json"]
    if len(jobs) != OBS_REPS or any(
            not set(want) <= set(f) for f in files.values()):
        raise AssertionError(f"obs_pagerank100k: history {files}")
    cli = obs_cli(history, os.path.join(history, jobs[-1], "events.jsonl"),
                  out_dir)
    med = {m: sorted(w)[len(w) // 2] for m, w in walls.items()}
    return {"nodes": n_nodes, "iters": PR_ITERS, "nparts": NPARTS,
            **sizes, "ranks_bit_equal": True,
            "warm_walls_s": dict(walls),
            "warm_wall_median_off_s": med["off"],
            "warm_wall_median_on_s": med["on"],
            "on_over_off": med["on"] / med["off"],
            "host_reads": reads["off"][0], "telemetry": tele["on"],
            "history_jobs": jobs, "history_files": want,
            "cli_s": cli}, ranks


def obs_profile_pagerank(port, hk, pr, edges, n_nodes, ranks, out_dir,
                         held) -> dict:
    """obs_profile_pagerank100k: one more warm PageRank run, in a context
    with ``JobConfig(profile_dir=...)`` (the executor profiles each of
    its runs and raises if a kernel launch in a profile has no device
    record; no other profiler is active), taken once.  Its kernel calls
    held, its ranks bit-equal to the unprofiled runs'; one Chrome trace
    per executor run, whose kernel events name the ``__global__`` kernel
    of every port kernel the run's launch counters counted
    (``DEVICE_NAMES``), each with nonzero device time summed over the
    traces and no more kernel events than launches.  Each trace's
    kernel launches are matched to their device records by correlation
    id: the first ``_PROFILE_PAD_LAUNCHES`` (the executor's pad, left
    out of every other count here) may lack one, and the line gives how
    many did per trace; the run's own launches without a record must be
    0 in every trace.  The traces are deleted once read."""
    from dryad_tpu_torch.exec.executor import _PROFILE_PAD_LAUNCHES
    def app(c):
        return pr.pagerank(c, edges, n_nodes, n_iters=PR_ITERS)

    prof_dir = tempfile.mkdtemp(prefix="profile-", dir=out_dir)
    try:
        ctx = port.Context(device="cuda", nparts=NPARTS,
                           config=port.JobConfig(profile_dir=prof_dir))
        hk.capture = {}
        out, launches, load, qs, runs = run_app(port, hk, app, ctx=ctx)
        captured, hk.capture = hk.capture, None
        held("obs_profile_pagerank100k", launches, captured)
        del captured
        r = np.asarray(out["rank"])[np.argsort(out["node"])]
        if r.tobytes() != ranks.tobytes():
            raise AssertionError("obs_profile_pagerank100k: ranks "
                                 "differ from the unprofiled runs'")
        paths = ctx.executor.profile_paths
        dev, seen = collections.Counter(), collections.Counter()
        n_ev, size, per_trace, pad_lost, lost = 0, 0, [], [], []
        for path in paths:
            size += os.path.getsize(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", ())
            calls, recs = [], set()
            for e in events:
                cat, name = e.get("cat"), e.get("name", "")
                corr = (e.get("args") or {}).get("correlation")
                if cat in DEVICE_CATS:
                    recs.add(corr)
                elif (cat in ("cuda_runtime", "cuda_driver")
                      and "Launch" in name and "Kernel" in name):
                    calls.append(corr)
            calls.sort()
            pad = set(calls[:_PROFILE_PAD_LAUNCHES])
            pad_lost.append(len(pad - recs))
            lost.append(sum(c not in recs
                            for c in calls[_PROFILE_PAD_LAUNCHES:]))
            per_trace.append(len(recs - pad))
            for e in events:
                if (e.get("cat") != "kernel" or (e.get("args") or {}).get(
                        "correlation") in pad):
                    continue
                dev[e["name"]] += float(e.get("dur", 0.0))
                n_ev += 1
                for k, subs in DEVICE_NAMES.items():
                    if any(sub in e["name"] for sub in subs):
                        seen[k] += 1
    finally:
        shutil.rmtree(prof_dir, ignore_errors=True)
    ours = {k: sum(v for n, v in dev.items()
                   if any(sub in n for sub in subs)) / 1e3
            for k, subs in DEVICE_NAMES.items()}
    missing = [k for k, n in launches.items() if n and not ours[k]]
    extra = [k for k in launches if seen[k] > launches[k]]
    if len(paths) != len(runs) or missing or extra or any(lost):
        raise AssertionError(
            f"obs_profile_pagerank100k: {len(paths)} traces for "
            f"{len(runs)} runs; {missing} launched but not in the traces' "
            f"kernels; {extra} with more kernel events than launches; "
            f"launches without a device record per trace {lost}")
    return {"profiled_wall_s": load + qs, "profiled_load_s": load,
            "profiled_query_s": qs, "traces": len(paths),
            "trace_bytes": size, "kernel_events": n_ev,
            "device_records_per_trace": per_trace,
            "pad_launches_without_record_per_trace": pad_lost,
            "launches_without_record_per_trace": lost,
            "device_ms": sum(dev.values()) / 1e3,
            "port_kernels_ms": ours, "launches": launches,
            "port_kernel_events": dict(seen),
            "top": [[k[:120], v / 1e3] for k, v in dev.most_common(6)]}


def phase15_runs(port, hk, cat, pr, edges, n_nodes, out_dir, held,
                 device="cuda", profile=True):
    """Phase 15's cells, each yielded as (label, line) when it is done:
    obs_sqlq3_6m over phase 14's catalog, then obs_pagerank100k and (with
    ``profile``, on the card) obs_profile_pagerank100k over phase 7's
    graph."""
    from dryad_tpu_torch import sql
    yield "obs_sqlq3_6m", obs_sqlq3(port, hk, sql, cat, held, device)
    line, ranks = obs_pagerank(port, hk, pr, edges, n_nodes, out_dir, held,
                               device)
    yield "obs_pagerank100k", line
    if profile:
        prof = obs_profile_pagerank(port, hk, pr, edges, n_nodes, ranks,
                                    out_dir, held)
        prof["unprofiled_wall_median_s"] = line["warm_wall_median_off_s"]
        yield "obs_profile_pagerank100k", prof


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
    [(kernel or memset name, count, device µs in all)].  One call runs
    before the window.  The window opens with the executor's pad
    (``_PROFILE_PAD_LAUNCHES`` launches of a one-element add, then a
    sync), since the profiler can drop a window's first device records;
    the pad's records are left out by correlation id."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dryad_tpu_torch.exec.executor import _PROFILE_PAD_LAUNCHES
    fn()
    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(_PROFILE_PAD_LAUNCHES):
            pad.add_(1)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    launched = sorted(e.correlation_id() for e in events
                      if e.device_type() != torch.autograd.DeviceType.CUDA
                      and "Launch" in e.name() and "Kernel" in e.name())
    skip = set(launched[:_PROFILE_PAD_LAUNCHES])
    count, us = collections.Counter(), collections.Counter()
    for e in events:
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and e.correlation_id() not in skip):
            count[e.name()] += 1
            us[e.name()] += e.duration_ns() / 1e3
    return [(k, count[k], us[k]) for k in count]


def profile_calls(name: str, fn, calls: int = 20, tries: int = 3,
                  per_call: int = 1) -> dict:
    """The row's kernel time per call at the timed shape, and the device
    events (kernels and memsets) per call, in all and by name.  The time
    per call is the mean of the kernel's recorded events times
    ``per_call``, the kernel's launches in one call of ``fn``.  A window
    that recorded none of the kernel's events is taken again, up to
    ``tries`` windows."""
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
    ap.add_argument("--stream-scale", type=float, default=1.0,
                    help="phase 13's data sizes times this (the chunks "
                    "stay): 10,000,000 TeraSort records, 100,000 PageRank "
                    "nodes, 500,000 points, 6,000,000 lineitems' orders")
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
    wc_counts = {}   # phase 3's in-memory WordCount counts by corpus

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
        wc_counts[cname] = got
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

    # phase 11: recovery and storage; stores in a temporary directory on
    # local disk, deleted at the end of the phase
    li9, orders9, _ = tpch_tables(a.lineitems)
    before = set(runs)
    tmp = tempfile.mkdtemp(prefix="dryad-phase11-")
    t11 = time.perf_counter()
    try:
        eleven = {
            "pagerank100k": pagerank_forms(port, hk, pr, edges, a.nodes,
                                           a.out, held),
            "settle": settle_runs(port, hk, ts, (tera_data, tera_sml), li9,
                                  orders9, held),
            "lineage": lineage_run(port, hk, li9, orders9, held),
            "spill": spill_runs(port, hk, li9, tmp, held),
            "store": store_round_trips(port, hk, li9, orders9, tmp, held),
            "read_text": read_text_run(port, hk, wc, corpora["bench12"],
                                       wc_counts["bench12"], tmp, held),
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    unheld = set(TPU_KERNEL) - {k for r in set(runs) - before
                                for k in runs[r][1]}
    if unheld:
        raise AssertionError(f"phase 11: no call of {sorted(unheld)} held")
    emit({"phase": "recovery", **eleven,
          "seconds": time.perf_counter() - t11, "card": card})
    del li9, orders9

    # phase 12: adaptive execution (each cell on and off), the cost model
    # cross-checking eight runs, the card against the oracle
    before = set(runs)
    t12 = time.perf_counter()
    for label, line in adapt_cells(port, hk, phase12_cells(
            a.lineitems, a.lineitems, a.orders), a.out, held).items():
        emit({"phase12": label, **line, "card": card})
    per_part = -(-len(corpora["zipf50k"]) // NPARTS)
    tera_keys = np.array(tera_data["key"], dtype="S10")
    tera_order = np.lexsort((tera_data["payload"], tera_keys))

    def tera_ok(out):
        if (out["key"] != tera_keys[tera_order].tolist()
                or not np.array_equal(out["payload"],
                                      tera_data["payload"][tera_order])):
            raise AssertionError("terasort1m: not the sorted pairs")

    def wc_ok(out):
        if dict(zip(out["line"], (int(v) for v in out["n"]))) != \
                wc_counts["zipf50k"]:
            raise AssertionError("zipf50k: counts differ from phase 3's")

    emit({"phase12": "cost_model", "card": card, **cost_runs(port, hk, {
        "zipf50k": (lambda c: wc.wordcount_query(
            c.from_columns({"line": corpora["zipf50k"]}, str_max_len=96),
            tokens_per_partition=per_part * 10).collect(), wc_ok),
        "app10k": (lambda c: variants["app10k"][1](
            c.from_columns(gbr_data)).collect(),
            lambda out: check_gbr("app10k", out, gbr_data,
                                  variants["app10k"][2])),
        "terasort1m": (lambda c: ts.terasort_query(c.from_columns(
            tera_data, str_max_len=tera_sml)).collect(), tera_ok),
        "pagerank100k": (lambda c: pr.pagerank(c, edges, a.nodes,
                                               n_iters=PR_ITERS),
                         lambda out: check_pagerank(out, edges, a.nodes,
                                                    pr)),
        "kmeans500k": (lambda c: km.kmeans(c, km_pts, KM_K,
                                           n_iters=KM_ITERS),
                       lambda out: check_kmeans(out, km_pts, km)),
    }, held)})
    emit({"phase12": "oracle", "card": card, **oracle_runs(
        port, hk, phase12_cells(ORACLE_ROWS, ORACLE_ROWS, ORACLE_ROWS), wc,
        corpora["bench12"][:ORACLE_LINES], held)})
    unheld = set(TPU_KERNEL) - {k for r in set(runs) - before
                                for k in runs[r][1]}
    if unheld:
        raise AssertionError(f"phase 12: no call of {sorted(unheld)} held")
    emit({"phase": "adaptive", "seconds": time.perf_counter() - t12,
          "card": card})

    # phase 13: out-of-core streaming through the streamed entry points,
    # the kernel calls of every run held; the scatter's histogram at its
    # shapes.  Its stores and files go to a directory under --out,
    # deleted at the end of the phase so that --out stays small
    before = set(runs)
    sc = a.stream_scale
    sizes13 = Phase13Sizes(
        records=int(10_000_000 * sc), small_records=int(1_000_000 * sc),
        app_records=int(2_000_000 * sc), nodes=int(100_000 * sc),
        points=int(500_000 * sc), lineitems=int(6_000_000 * sc))
    tmp = tempfile.mkdtemp(prefix="phase13-", dir=a.out)
    t13 = time.perf_counter()
    try:
        thirteen = phase13_runs(port, hk, sizes13, tmp, corpora["bench12"],
                                wc_counts["bench12"], held)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    scatter = thirteen.pop("scatter_calls")
    for label, line in thirteen.items():
        emit({"phase13": label, **line, "card": card})
    emit({"phase13": "scatter_hist",
          "rows": scatter_hist_rows(hk, scatter, card), "card": card})
    del scatter
    unheld = {"hist_buckets", "prefix_sum", "prefix_sum2"} - {
        k for r in set(runs) - before for k in runs[r][1]}
    if unheld:
        raise AssertionError(f"phase 13: no call of {sorted(unheld)} held")
    emit({"phase": "streaming", "seconds": time.perf_counter() - t13,
          "card": card})

    # phase 14: the SQL front end (sql.query -> collect, lint "warn") over
    # the SF1 lineitems and orders; every kernel call of each cold run held
    from dryad_tpu_torch import sql
    tables14 = sql_catalog(sql, a.lineitems)
    before = set(runs)
    t14 = time.perf_counter()
    for label, line in phase14_runs(port, hk, a.lineitems, held,
                                    a.out, tables14).items():
        emit({"phase14": label, **line, "card": card})
    new = set(runs) - before
    launches14 = {k: sum(runs[r][0][k] for r in new) for k in TPU_KERNEL}
    unheld = set(TPU_KERNEL) - {k for r in new for k in runs[r][1]}
    if unheld or not all(launches14.values()):
        raise AssertionError(f"phase 14: launches {launches14}, no call of "
                             f"{sorted(unheld)} held")
    emit({"phase": "sql", "launches": launches14,
          "seconds": time.perf_counter() - t14, "card": card})

    # phase 15: observability: EXPLAIN ANALYZE over phase 14's catalog,
    # PageRank on phase 7's graph with telemetry off and on (the history
    # archive and the obs CLI), then under JobConfig.profile_dir
    before = set(runs)
    t15 = time.perf_counter()
    obs_dir = os.path.join(a.out, "phase15")
    shutil.rmtree(obs_dir, ignore_errors=True)
    os.makedirs(obs_dir)
    for label, line in phase15_runs(port, hk, tables14[2], pr, edges,
                                    a.nodes, obs_dir, held):
        emit({"phase15": label, **line, "card": card})
    del tables14
    new = set(runs) - before
    launches15 = {k: sum(runs[r][0][k] for r in new) for k in TPU_KERNEL}
    unheld = set(TPU_KERNEL) - {k for r in new for k in runs[r][1]}
    if unheld or not all(launches15.values()):
        raise AssertionError(f"phase 15: launches {launches15}, no call of "
                             f"{sorted(unheld)} held")
    emit({"phase": "observability", "launches": launches15,
          "seconds": time.perf_counter() - t15, "card": card})

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
    emit({"phase": "script", "seconds": time.perf_counter() - started,
          "card": card})
    print(card)
    emit({"kernels": rows})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
