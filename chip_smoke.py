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
     exchange); then ``q1int64``, TPC-H Q1's aggregate set over five
     int64 decimals (as many rows, two int32 keys of 3 and 2 values),
     held exactly against numpy: the group op's scan lowering in both
     stages, so ``seg_scan`` once per partition at least.  Every main-path run's
     segmented scans (``seg_scan_calls``) are held against the plain
     version and their launches counted against the run's counters;
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
     exchanges and one broadcast) and warm:
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
     warm (unprofiled: cut for the script's time) in the cold run's context: the
     orders
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
     (``Executor.host_reads``: one per executor run when deferred) and
     warm wall (its profiled run cut for the script's time); terasort1m and skewjoin6m with
     an event log, exactly numpy's, the ``settle_replay`` events naming
     exactly the stages the log flags ``settle_replayed``, launches equal
     to the executor's exchange attempts with the replays, and
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
     between the modes and numpy's (f32 sums within 16 eps sum|v|); one
     warm run per mode in turns, NEED reads per run, the order_by stage's
     output bytes, one profiled warm run of the adaptive mode (busy
     share).  The
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
     (key, payload) multiset; ``ooc_inflight`` 2 cold, warm and
     profiled, the in-core tier once, the depth-2 query at 1,000,000
     records (the big warm run's peak device memory above its start
     must be at most 1.5 times this run's), and the ``terasort_ooc``
     app at 2,000,000; ``hist_buckets`` once per chunk scattered, the
     in-core tier none), ``pagerankstream100k`` (phase 7's graph from a store,
     ``pagerank_stream`` over its ``cache()``, STREAM_PR_ITERS (5)
     supersteps (cut for the script's time): ranks within rtol 2e-3,
     two cache writes cold, at least two hits a superstep),
     ``kmeansstream500k`` (phase 8's points from a store,
     ``kmeans_stream``: within 1e-3), ``q13stream1m5_right`` /
     ``_full`` (the SF1 orders streamed, right / full joined with the
     150,000 customers, orders per customer exactly numpy's, the 50,000
     without an order present) and ``readtextstream1m`` (the bench12
     corpus from a file, WordCount equal to phase 3's counts).  Each
     cold (held, host syncs counted) and warm (wall, rows/s, chunks and
     bytes copied each way, prefetch stalls, peak device memory),
     terasortooc10m also profiled warm (busy share); no exchange kernel
     launches; then the
     scatter's histogram at its shapes against ``bincount`` and its
     bound (``scatter_hist``);
  14. the SQL front end (``sql.query(ctx, catalog, text).collect()``,
     ``JobConfig(lint="warn")``) over phase 9's SF1 lineitems with
     ``price`` float32 and a ``tag`` string column, registered in a
     ``sql.Catalog``: ``sqlq3_6m`` adaptive off and on (bench.py's
     skewed join + filter + per-order revenue, ORDER BY revenue DESC
     LIMIT 10; cold each, then one warm run of each in turns, the off
     one also profiled),
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
     inside its predicted rows and its predicted bytes (predicted at the
     rescaled join's capacity where that capacity reaches the stage),
     zero ``cost_model_miss``, the join's
     unsalted retry: 2 runs); ``obs_pagerank100k`` (PageRank OBS_REPS
     times with telemetry off, no event log, and as often on,
     ``EventLog(level=2, history_dir=..., app="pagerank")`` with
     ``JobConfig(resource_sample_s=0.1)``, in turns: ranks bit-equal
     across all of them and within rtol 2e-3 of ``pagerank_numpy``,
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
  16. incremental queries and the network stores over a quarter of
     phase 14's lineitems (``--lineitems / INC_SCALE``, SF 0.25 since
     cut for the script's time; the labels keep ``6m``; ``tag`` 8 bytes), each
     store under ``--out``, deleted
     after: ``remote_s3_6m`` (``to_store("s3://...")`` on the loopback
     ``tests/torch_fakes.FakeS3``, which verifies every SigV4 signature,
     with 8 MiB multipart puts; ``read_store``; SQL_Q1 over it equal to
     a local store's table; ``ctx.read("s3://bkt/text/")`` of bench12's
     text in four objects counted by WordCount equal to phase 3's
     counts), ``remote_hdfs_6m`` (the same on ``tests/webhdfs_fake``,
     then ``read_store_stream`` by ranged reads with
     ``ChunkSource.RANGED_STREAM_MIN_BYTES`` at the smallest partition's
     bytes, a streamed ``to_store`` to ``hdfs://`` and ``hdfs://`` text,
     each equal to its local run), ``remote_http_text`` (``ctx.read``
     of a ``/`` listing on ``tests/torch_fakes.RangeServer`` by 2 MiB
     ranged GETs), then ``inc_q1_6m`` and ``inc_okey_6m`` (a store of
     NPARTS partitions; INC_ROUNDS rounds of one RF1-sized ``append_store``
     of one partition, ``run_refresh`` and the full ``sql.query`` of the
     same EMIT EVERY statement: integers bit-equal, f32 sums and means
     within 16 eps sum |v|, one delta partition of the appended rows)
     and ``inc_modes`` (DTA402 rescans, the append shape, a crashed
     commit that changes nothing, a noop, a DTA403 rebuild).  Byte rates
     measure loopback.  All five kernels must launch;
  17. the job service on the in-process fleet
     (``dryad_tpu_torch.service.JobService(device="cuda")``, fleet
     threads on the device's default stream, services under ``--out``,
     deleted after): ``svc_sql_6m`` (slots 2, the journal fsynced; three
     tenants of shares 2 / 1 / 1 each submit SQL_Q1, SQL_Q3 and an
     equivalent form of each over phase 14's catalog: every result
     against numpy, DTA501 on the 10 equivalent submissions, ONE ``scan``
     io span per table and ``scan_shared`` for every other use, each
     job's events tagged with its id; per-tenant p50 / p95 walls, a warm
     Q3 job's wall beside phase 14's), ``svc_wordcount`` (SVC_WC_JOBS
     ``wordcount`` app jobs of 500,000 lines through the fleet against
     the same jobs run one after another without the service, counts
     against ``collections.Counter``); the next three cells over a
     quarter of the lineitems (SVC_SCALE, cut for the script's time; the labels keep
     ``6m``): ``svc_durable_6m``
     (``durable_spill``: SQL_Q3 paused by ``handoff()`` after its first
     settled stage and resumed by a successor from spill,
     ``stage_restored`` for exactly the settled stages; four SQL jobs on
     one slot, ``crash()`` after the first, the other three re-admitted
     in ``seq`` order, each tenant charged once per job),
     ``svc_standing_6m`` (INC_Q1 registered through ``submit_sql`` over a
     store of the lineitems, INC_ROUNDS RF1 appends, each refresh's merge
     against the full query; ``crash()``, an append while down, the
     successor's next refresh holding exactly it) and ``svc_http``
     (``service.http.serve`` on loopback: ``POST /sql`` through
     ``Client`` followed over SSE to ``event: done``, ``GET /metrics``
     listing plan reuse and shared scans, one ``python -m
     dryad_tpu_torch.service submit --wait`` subprocess).  The launch
     counters are process-wide, so the phase reads per-cell totals; all
     five kernels must launch;
  18. worker processes on the card: one ``runtime.LocalCluster(2, 8)``
     (two ``python -m dryad_tpu_torch.runtime.worker`` processes, each
     with its own CUDA context and 8 logical partitions) serves
     ``farm_groupsum_8m`` (``runtime.farm.TaskFarm``: 8,000,000 rows,
     4,096 keys, 16 tasks, merged sums against numpy exactly; a plain
     run, a ``delay_hook`` straggler duplicated exactly once with the
     copy winning, and a last run SIGKILLing worker 1 mid-farm, its task
     reassigned), ``svc_cluster_wordcount`` (phase 17's three 500,000-line
     jobs through ``JobService(cluster=...)``, counts against
     ``collections.Counter``, ``fleet_s`` / ``submit_s`` beside phase
     17's), ``svc_cluster_sql_6m`` (SQL_Q1 and SQL_Q3 twice each over
     phase 14's tables written as stores that each task's worker reads:
     numpy's checks, DTA501 on the second of each, each equal to its
     tasks replayed here) and ``forensics_replay`` (a poison wordcount task's
     bundle replayed by ``python -m dryad_tpu_torch.obs replay --device
     cuda``: REPRODUCED); then ``chaos_seed3``
     (``chaos.run_scenario(seed=3, device="cuda")``: ok, a settled stage
     spilled before the SIGKILL and restored after it, the standing query
     recovered).  The farm and service cells' launches are the workers'
     (each reply's ``launches``, summed from ``task_done``); their calls
     are held on every task run the workers reported, replayed in this
     process in each worker's order through an executor per worker kept
     for the phase; chaos_seed3's are its successor's, here.  All five
     kernels must launch;
  19. the gang: one ``runtime.LocalCluster(2, 4)`` on the card (P = 8,
     as in phases 3-7: each worker holds four partitions, the exchanges
     cross the two processes host-staged over gloo) runs each cell as
     gang jobs (one run each since PR 20's cuts), beside the same query
     in this process on the gang's own ``(dcn, dp)`` mesh, whose levels
     a gang plans (``make_mesh(..., hosts=2)``):
     ``gang_zipf50k`` (WordCount over phase 3's zipf corpus: the
     in-process table and the ``Counter`` oracle's counts),
     ``gang_terasort1m`` (TeraSort on phase 6's 1,000,000 records: the
     in-process rows in order, the range exchange's rows per partition
     equal), ``gang_pagerank100k`` (phase 7's graph, 10 supersteps by
     ``do_while`` with the loop state resident on the workers: ranks
     within rtol 2e-3 of ``pagerank_numpy`` and within 1e-6 of the
     in-process run's, every superstep's control message under
     ``GANG_STEP_BYTES``), ``gang_skewjoin6m`` (phase 9's SF1 tables:
     the join stage unsalted then salted at attempt 2, the same in
     both workers' logs and in the in-process log), ``gang_store_cache``
     (TeraSort's output through parallel gzip ``to_store``, read back by
     ``from_store``, then a ``cache()`` healed through
     ``MissingResidentToken`` after ``restart()``) and
     ``gang_watchdog`` (a SIGSTOPped worker declared wedged and the job
     replayed on a fresh gang whose slow worker 1, its heartbeats
     flowing, is not).  Per cell: walls, the staged collectives' D2H /
     gloo / H2D seconds and host syncs per exchange, each worker's
     launches per kernel (hist_buckets, slot_expand and slot_compact
     once per exchange in each worker, by its log); the workers' calls
     held on a replay of TeraSort and two PageRank supersteps here as a
     gang of two threads (``replay_gang``), at the workers' shapes, the
     range bounds bit-equal to the in-process run's;
  20. the streamed gang and the SSH backend: one ``LocalCluster(2, 4)``
     on the card (P = 8) runs phase 13's streamed queries over phase
     13's stores (kept until this phase ends) as gang jobs of chunk
     waves (``runtime/stream_plan.py``), beside phase 13's in-process
     runs (cold and warm, but for PageRank and the SSH cell, one run
     each): ``gang_stream_terasort10m`` (the 10,000,000
     TeraGen records in 262,144-row chunks, ``order_by(key)`` to a local
     store cold and to ``hdfs://`` on ``tests/webhdfs_fake`` warm, every
     worker uploading its own parts: the rows equal to phase 13's, keys
     in byte order, the range bounds equal in both workers and to a
     plain numpy cut from the store's partitions (``numpy_gang_cut``);
     ``take(1,000)`` after the sort of
     the 1,000,000-record store the head of phase 13's output),
     ``gang_stream_wordcount1m`` (bench12's file through
     ``read_text_stream``, spooled under ``cluster_stream_spool_dir``:
     the ``Counter``'s counts, the group partials in the waves),
     ``gang_stream_pagerank100k`` (phase 13's edges as a cluster
     re-streaming ``cache()``, written by the run and hit by the two
     ``cache()`` calls again, STREAM_PR_ITERS supersteps with the ranks
     resident: within 1e-6 of phase 13's ranks),
     ``gang_stream_q13_1m5`` (the SF1 orders right- and full-joined
     with the 150,000 customers, orders per customer exactly numpy's,
     and a ``zip_with`` of two selects of the store) and
     ``ssh_gang_zipf50k`` (an ``SshCluster`` of two hosts over ``bash
     -c``, the code staged into a fresh root whose kernels its workers
     build: phase 19's WordCount table, then worker 1's transport killed
     and the next job on a fresh gang).  Per cell: walls, waves,
     retries and exchange attempts, the staged collectives' D2H / gloo
     / H2D seconds, bytes spilled to bucket stores, each worker's
     launches (``slot_expand`` once a hash or range wave attempt,
     ``slot_compact`` once a wave attempt); the SSH cell's staging and
     kernel-build seconds.  The workers' calls held on a replay of one
     TeraSort wave and one PageRank superstep here as a gang of two
     threads (``replay_stream_gang``);
  21. multi-axis meshes and hierarchical group aggregation: phase 4's
     GroupByReduce data (``--rows``) on ``make_mesh("cuda", 8,
     hosts=2)`` (``mesh2d_app10k``: combine stages ``groupby-dp``,
     ``groupby-dcn``) and ``make_mesh("cuda", 8, hosts=2, pods=2)``
     (``mesh3d_app10k``: ``groupby-dp``, ``groupby-host``,
     ``groupby-dcn``), phase 4's user Decomposable on the 2-D mesh
     (``mesh2d_decomposable10k``: ``dgroupby-dp``, ``dgroupby-dcn``) and
     phase 3's zipf corpus on it (``mesh2d_wordcount``), each cold (every
     kernel call held, one launch of each exchange kernel a level) and
     warm, held to the numpy oracle and to phase 4's one-axis tables
     (counts, min and max exactly, f32 sums within the group bound) or
     to the ``Counter``'s counts; then one ``LocalCluster(2, 4)`` on the
     card, whose mesh is ``(dcn, dp)`` with ``dcn`` the process
     boundary: ``gang_mesh_app10k`` (the app equal row for row to the
     in-process 2-D run; each worker's ``dp`` hop stages 0 bytes, its
     ``dcn`` hop one all_to_all) and ``gang_adaptive_collapse`` (an
     ``adaptive="on"`` job over 500 keys whose aggregation tree
     collapses: the same rewrites on every worker, the result equal to
     the ``adaptive="off"`` run and to numpy).  The workers' calls held
     on a replay of the gang's app here as a gang of two threads;
 3-21. after each of those main-path runs, every kernel call it made
     is made again through the kernel and through its plain version on
     the very tensors the run passed (integers exactly, prefix_sum2
     within twice its bound);
  5. timing: each kernel, its plain version and one library call at the
     largest call of one main-path run (``TIMED_ON``; CUDA events), the
     bound the card's memory rate sets for the same bytes, and a
     torch.profiler breakdown of one warm run of each timed path
     (PageRank's is phase 11's deferred form; each window opens with the
     executor's 1,024-launch pad and closes with 8,192 more; a window in
     which a launch of the run has no device record is discarded, with
     a ``profile_window_discarded`` line, and taken again, at most
     PROFILE_WINDOWS windows in all; a launched kernel that shows no
     device time, or a loss in every window, fails the run).
     Per kernel at its timed shape also: the device time per call and the
     device events (kernels, memsets) per call from a profiler window
     around 20 calls, and the host's enqueue time per call (200 calls, no
     sync); for slot_compact, whose call is one exchange's unpack, also a
     loop of one-destination calls on the same tensors (``loop_ms``,
     its device µs per exchange and host enqueue).  Per kernel and path
     (the two timed paths): the bound of
     the path's captured calls summed beside the path's profiled device
     time (``path_bound`` lines).  The exchange's pack side per exchange
     in the two timed paths' profiles
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
(``{"phase15": ...}``) and the phase's launches, one per phase-16 cell
(``{"phase16": ...}``) and the phase's launches, one per phase-17 cell
(``{"phase17": ...}``) and the phase's launches, one per phase-18 cell
(``{"phase18": ...}``) and the phase's launches (``{"phase":
"cluster", ...}``, with each cell's worker launches), one per phase-19
cell (``{"phase19": ...}``) and the phase's (``{"phase": "gang",
...}``), one per phase-20 cell (``{"phase20": ...}``) and the phase's
(``{"phase": "stream_gang", ...}``), one per phase-21 cell
(``{"phase21": ...}``) and the phase's (``{"phase": "mesh", ...}``),
per profile, per
pack side
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
import atexit
import collections
import contextlib
import dataclasses
import functools
import hashlib
import itertools
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
# the five and the key hash (hash_keys: no TPU counterpart), which every
# hashing path launches
HASHING = (*TPU_KERNEL, "hash_keys")
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
    "hash_keys": ("key_hash_rows",),
    "seg_scan": ("seg_tile_reduce", "seg_tile_carry", "seg_tile_apply"),
}
# device kernels a wrapper call may launch (seg_scan: reduce, carry, apply)
KERNELS_A_CALL = {"seg_scan": 3}
SEG_HOLD_BYTES = 6 << 30      # a run's held segmented-scan inputs, at most
PACK_RANGE = "dryad.exchange.pack"   # parallel/shuffle.py's profiler range
# the runs whose calls are kept for a pack_side line
PROFILED = ("zipf50k", "app10k")


_ORACLES: dict = {}


def host_memo(fn):
    """``fn`` computed once per argument identity (numbers and strings by
    value, any other object by identity, kept alive beside the result so
    that an id is never reused): the phases hold many runs of one query
    to one oracle."""
    def memoized(*args):
        key = (fn.__name__,) + tuple(
            a if isinstance(a, (int, float, str)) else ("id", id(a))
            for a in args)
        if key not in _ORACLES:
            _ORACLES[key] = (args, fn(*args))
        return _ORACLES[key][1]
    return memoized


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
    check_hash_keys(hk, t, rng)

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


def check_hash_keys(hk, t, rng) -> None:
    """``hash_batch_keys`` on the card (the ``hash_keys`` kernel, one
    launch a call) bit-identical to its plain version ``hash_columns`` on
    the same data on the CPU, whose float conversions (a NaN's bits among
    them) the kernel follows: every key kind, one to three columns, views,
    capacities from 0 rows to 2**25 + 3 (there three int32 keys, held to
    the plain version on the card)."""
    import torch
    from dryad_tpu_torch.data.columnar import Batch, StringColumn, map_column
    from dryad_tpu_torch.ops import hashing

    def strings(n, L):
        lens = rng.randint(-1, L + 3, n).astype(np.int32)
        return StringColumn(t(rng.randint(0, 256, (n, L)).astype(np.uint8)),
                            t(lens))

    def f64(n):
        v = rng.randn(n) * 10.0 ** rng.randint(-320, 300, n)
        edge = [0.0, -0.0, np.nan, -np.inf, 1e-40, -1e-50, 1e300, 5e-324]
        v[:len(edge)] = edge[:n]
        return t(v)

    for n in (0, 1, 1023, 1025, 4097, 1_000_003, (1 << 25) + 3):
        i32 = lambda: rng.randint(-2**31, 2**31 - 1, n).astype(np.int32)
        sets = [{"a": t(i32()), "b": t(i32()), "c": t(i32())}]
        if n <= 1_000_003:
            sets += [
                {"k": t(rng.randint(-2**62, 2**62, n))},
                {"k": t(rng.randint(-2**62, 2**62, (n, 3)))},
                {"f": f64(n), "g": f64(n).float()},
                # no half NaN: the CPU's own bits for one depend on the
                # tensor's length (its scalar and vector conversions)
                {"h": torch.nan_to_num(f64(n)).half(),
                 "e": f64(n).bfloat16(), "b": t(rng.rand(n) < 0.5),
                 "i": t(rng.randint(-128, 128, n).astype(np.int8))},
                {"s": strings(n, 24), "j": t(i32())},
                {"s": strings(n, 512)},
                {"v": t(rng.randint(-2**31, 2**31 - 1, (n, 4))
                        .astype(np.int32))[:, 1:3],
                 "w": t(i32().repeat(2))[::2]},
                # more key columns than one launch takes
                {**{f"c{i:02d}": t(i32()) for i in range(37)},
                 "c31": strings(n, 24), "c33": f64(n),
                 "c37": t(rng.randint(-2**62, 2**62, n)),
                 "c38": t(rng.rand(n) < 0.5),
                 "c39": t(rng.randint(-2**31, 2**31 - 1, (n, 2))
                          .astype(np.int32))}]
        for cols in sets:
            batch = Batch(cols, torch.tensor(n, dtype=torch.int32,
                                             device="cuda"))
            before = hk.launches["hash_keys"]
            hi, lo = hashing.hash_batch_keys(batch, list(cols))
            torch.cuda.synchronize()
            if hk.launches["hash_keys"] - before != hash_launches(
                    hashing, [list(cols.values())]):
                raise AssertionError("hash_keys: not one launch a call "
                                     "per 32 key columns")
            if n > 1_000_003:
                phi, plo = hashing.hash_columns(list(cols.values()))
            else:
                phi, plo = (x.cuda() for x in hashing.hash_columns(
                    [map_column(c, lambda x: x.cpu())
                     for c in cols.values()]))
            if not (torch.equal(hi, phi) and torch.equal(lo, plo)):
                raise AssertionError(f"hash_keys {sorted(cols)} n={n}: "
                                     f"kernel != plain")


def _hash_rows(cols) -> int:
    """The rows of a ``hash_batch_keys`` call's key columns."""
    c = cols[0]
    return c.capacity if hasattr(c, "capacity") else c.shape[0]


def hash_launches(hashing, calls) -> int:
    """``hash_keys`` launches of these calls (each its key columns): one
    per ``hashing._MAX_KEY_COLS`` columns, none for zero rows."""
    return sum(-(-len(cols) // hashing._MAX_KEY_COLS) for cols in calls
               if _hash_rows(cols))


@contextlib.contextmanager
def hash_calls(hashing):
    """Within it, the ``hash_batch_keys`` calls of a main-path run by
    route: ``kernel`` the key columns of each call routed to
    ``hash_keys``, ``plain_on_card`` the calls of the plain version on
    CUDA columns (none where the routing holds).  Through the module
    globals ``hash_batch_keys`` looks up, not the ``capture`` hook."""
    rec = {"kernel": [], "plain_on_card": 0}
    kernel, plain = hashing._hash_keys, hashing.hash_columns

    def on_kernel(cols):
        rec["kernel"].append(list(cols))
        return kernel(cols)

    def on_plain(cols):
        if any(t.is_cuda for t in hashing._tensors(cols)):
            rec["plain_on_card"] += 1
        return plain(cols)

    hashing._hash_keys, hashing.hash_columns = on_kernel, on_plain
    try:
        yield rec
    finally:
        hashing._hash_keys, hashing.hash_columns = kernel, plain


def hold_hashes(hashing, run, launches, rec) -> float:
    """A run's ``hash_keys`` launches against its kernel-routed calls
    (none plain on the card), then each call made again through the
    kernel and the plain version on the card: equal bits.  Returns the
    largest |kernel - plain|, 0."""
    import torch
    want = hash_launches(hashing, rec["kernel"])
    if rec["plain_on_card"] or launches["hash_keys"] != want:
        raise AssertionError(
            f"{run}: {launches['hash_keys']} hash_keys launches for "
            f"{len(rec['kernel'])} kernel calls ({want} launches), "
            f"{rec['plain_on_card']} plain calls on the card")
    for i, cols in enumerate(rec["kernel"]):
        got, plain = hashing._hash_keys(cols), hashing.hash_columns(cols)
        torch.cuda.synchronize()
        if not all(torch.equal(g, p) for g, p in zip(got, plain)):
            raise AssertionError(f"hash_keys {run} call {i}: kernel != "
                                 f"plain")
    return 0.0


def seg_scan_launches(hk, calls) -> int:
    """``seg_scan`` launches of these calls (each its leaves and flags):
    one per ``hk._SEG_MAX_LANES`` lanes (a column of an [n, k] leaf is a
    lane), none for zero rows."""
    total = 0
    for leaves, starts in calls:
        lanes = sum(1 if v.dim() == 1 else v.shape[1] for v, _ in leaves)
        if starts.shape[0] and lanes:
            total += -(-lanes // hk._SEG_MAX_LANES)
    return total


def seg_scan_calls(hk) -> dict:
    """Record, from now on, the group op's segmented scans made inside a
    main-path run's capture window (while ``hk.capture`` is set):
    ``window`` the kernel-routed calls (leaves, flags) not yet held,
    ``since_reset`` those since the last ``hk.reset_launches()``,
    ``plain_on_card`` the plain version's calls on CUDA tensors (none
    where the routing holds), ``dropped`` the calls past
    ``SEG_HOLD_BYTES`` of held inputs, counted but not kept.  Through the
    module globals ``kernels._seg_scan_multi`` looks up, not the
    ``capture`` hook; ``rec["restore"]()`` puts them back."""
    rec = {"window": [], "since_reset": [], "plain_on_card": 0,
           "dropped": 0, "bytes": 0, "kernel": hk.seg_scan_multi,
           "plain": hk.seg_scan_multi_plain}
    reset = hk.reset_launches

    def on_kernel(vals_ops, is_start):
        if hk.capture is not None:
            call = (list(vals_ops), is_start)
            rec["since_reset"].append(call)
            size = sum(v.numel() * v.element_size() for v, _ in vals_ops)
            if rec["bytes"] + size <= SEG_HOLD_BYTES:
                rec["window"].append(call)
                rec["bytes"] += size
            else:
                rec["dropped"] += 1
        return rec["kernel"](vals_ops, is_start)

    def on_plain(vals_ops, is_start):
        if is_start.is_cuda:
            rec["plain_on_card"] += 1
        return rec["plain"](vals_ops, is_start)

    def on_reset():
        rec["since_reset"] = []
        reset()

    def restore():
        hk.seg_scan_multi, hk.seg_scan_multi_plain = (rec["kernel"],
                                                      rec["plain"])
        hk.reset_launches = reset

    hk.seg_scan_multi, hk.seg_scan_multi_plain = on_kernel, on_plain
    hk.reset_launches = on_reset
    rec["restore"] = restore
    return rec


def hold_seg_scans(hk, run, launches, rec, count: bool):
    """A run's segmented scans: with ``count``, its ``seg_scan`` launches
    against its kernel calls since the last reset; none plain on the
    card; then each call of its window made again through the kernel and
    the plain version on the card: integers, bool and min / max equal
    (NaN where the plain version has NaN), float sums NaN where the plain
    version's are, else within 16 eps x the running sum of magnitudes.
    Returns the largest |kernel - plain| (float sums), 0 for a run whose
    scans are all exact, None for a run with no scan."""
    import torch
    window, calls = rec["window"], rec["since_reset"]
    rec["window"], rec["since_reset"], rec["bytes"] = [], [], 0
    want = seg_scan_launches(hk, calls)
    if rec["plain_on_card"] or (count and launches.get("seg_scan", 0)
                                != want):
        raise AssertionError(
            f"{run}: {launches.get('seg_scan')} seg_scan launches for "
            f"{len(calls)} kernel calls ({want} launches), "
            f"{rec['plain_on_card']} plain calls on the card")
    if not window:
        return None
    err = 0.0
    for i, (leaves, starts) in enumerate(window):
        got = rec["kernel"](leaves, starts)
        plain = rec["plain"](leaves, starts)
        for j, ((v, op), g, p) in enumerate(zip(leaves, got, plain)):
            gn, pn = ((torch.isnan(g), torch.isnan(p))
                      if g.is_floating_point() else (None, None))
            if not g.is_floating_point():
                ok = torch.equal(g, p)
            elif op is torch.add:
                mag = rec["plain"]([(v.double().abs(), torch.add)],
                                   starts)[0]
                eps = torch.finfo(g.dtype).eps / 2
                d = torch.where(gn, 0.0, (g.double() - p.double()).abs())
                ok = torch.equal(gn, pn) and bool(
                    (d <= 16 * eps * mag.nan_to_num(0.0)).all())
                err = max(err, float(d.max()) if d.numel() else 0.0)
            else:
                ok = torch.equal(gn, pn) and torch.equal(
                    torch.where(gn, 0.0, g), torch.where(pn, 0.0, p))
            if not ok:
                raise AssertionError(f"seg_scan {run} call {i} leaf {j} "
                                     f"({v.dtype}, {op.__name__}): "
                                     f"kernel != plain")
    return err


def hash_work(cols) -> tuple:
    """(bytes, 32-bit integer operations) of one ``hash_keys`` call,
    counted from its source: each key element read once and the two
    int64 lanes written; 44 operations a 32-bit word (its two mixes and
    the fold into its column's lanes; an int64 element is two words), 28
    for each further column's combine, and a string's bytes up to its
    length, 5 operations each, with 60 a row for its length's mixes and
    the fold."""
    import torch
    n = _hash_rows(cols)
    nbytes, ops = 16 * n, 28 * n * (len(cols) - 1)
    for c in cols:
        if hasattr(c, "lengths"):
            used = int(c.lengths.long().clamp(0, c.max_len).sum())
            nbytes += 4 * n + used
            ops += 5 * used + 60 * n
        else:
            elems = n * (c.shape[1] if c.dim() == 2 else 1)
            nbytes += c.element_size() * elems
            ops += 44 * elems * (2 if c.dtype in (torch.int64, torch.uint64)
                                 else 1)
    return nbytes, ops


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


Q1_INT64_AGGS = {"sum_qty": ("sum", "qty"), "sum_price": ("sum", "price"),
                 "sum_disc_price": ("sum", "disc_price"),
                 "sum_charge": ("sum", "charge"), "avg_qty": ("mean", "qty"),
                 "avg_price": ("mean", "price"), "avg_disc": ("mean", "disc"),
                 "n": ("count", None)}


def q1_int64_data(n: int, seed: int = 0) -> dict:
    """TPC-H Q1's group-by shape: two small int32 keys (flag: 3 values,
    status: 2) and five int64 decimal columns below 10**11."""
    rng = np.random.RandomState(seed)
    cols = {"flag": rng.randint(0, 3, n).astype(np.int32),
            "status": rng.randint(0, 2, n).astype(np.int32)}
    for c in ("qty", "price", "disc", "disc_price", "charge"):
        cols[c] = rng.randint(0, 10**11, n, dtype=np.int64)
    return cols


def q1_int64_query(ctx, data):
    """Q1's aggregate set over int64 decimals: 8-byte sums, so the group
    op's scan lowering in the partial and the final stage."""
    return ctx.from_columns(data).group_by(["flag", "status"],
                                           Q1_INT64_AGGS).collect()


def check_q1_int64(out, data) -> int:
    """Against numpy: the groups, counts and int64 sums exactly, the means
    within 1e-6 of the exact quotient.  Returns the number of groups."""
    key = data["flag"] * 2 + data["status"]
    got = np.asarray(out["flag"]) * 2 + np.asarray(out["status"])
    if sorted(got.tolist()) != sorted(set(key.tolist())):
        raise AssertionError(f"q1int64: groups {sorted(got.tolist())}")
    for i, k in enumerate(got.tolist()):
        g = key == k
        n = int(g.sum())
        if int(out["n"][i]) != n:
            raise AssertionError(f"q1int64: group {k} counts {out['n'][i]}")
        for name, (kind, col) in Q1_INT64_AGGS.items():
            if kind == "sum" and int(out[name][i]) != int(data[col][g].sum()):
                raise AssertionError(f"q1int64: group {k} {name} differs")
            if kind == "mean":
                want = int(data[col][g].sum()) / n
                if abs(float(out[name][i]) - want) > 1e-6 * abs(want):
                    raise AssertionError(f"q1int64: group {k} {name} "
                                         f"{out[name][i]} != {want}")
    return len(got)


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
STREAM_PR_ITERS = 5     # phases 13 and 20's streamed PageRank supersteps:
                        # cut from PR_ITERS for the script's time
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
    ``kmeans_numpy`` (computed once per point set: ``host_memo``)."""
    ref = _kmeans_ref(km, pts["x"], KM_K, KM_ITERS)
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


@host_memo
def _kmeans_ref(km, x, k: int, iters: int):
    return km.kmeans_numpy({"x": x}, k, iters)


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
    return tuple(dict(t) for t in _tpch_tables(n_items, seed))


@functools.lru_cache(maxsize=2)
def _tpch_tables(n_items: int, seed: int):
    """The tables of ``tpch_tables``, made once per size and seed (five
    phases read SF1's); callers get dicts of their own over the same
    arrays, which no caller writes in place."""
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
    (``Executor.host_reads``).  (The deferred form's profiled warm run
    and the timed warm run of each form in turns were cut for the
    script's time: phase 15 profiles PageRank.)  The ranks must be
    bit-identical between the forms, every
    rank within PR_RTOL of ``pagerank_numpy``, and the launches equal
    but for the exchanges of the stages that the deferred settle re-ran
    because a stage before them overflowed (``settle_extra``): stage by
    stage the deferred form runs exactly one attempt more there and the
    same attempts elsewhere."""
    import torch
    forms, ranks, launched, entries, probes = {}, {}, {}, {}, {}

    def app(c):
        return pr.pagerank(c, edges, n_nodes, n_iters=PR_ITERS)

    for form, cfg in (("deferred", port.JobConfig()),
                      ("sync", port.JobConfig(deferred_needs=False))):
        ctx = port.Context(device="cuda", nparts=NPARTS, config=cfg)
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
        forms[form] = {
            "host_syncs_per_run": syncs, "sync_sites": sites,
            "need_reads_per_run": reads,
            "need_reads_counted_run": counted_reads,
            "executor_runs": len(runs),
            "stage_attempts": sum(st["attempts"] for r in runs
                                  for st in r["stages"]),
            "warm_wall_s": load + qs, "warm_load_s": load,
            "warm_query_s": qs, "counted_run_s": counted_s,
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


ADAPT_WARM_REPS = 1     # each cell's timed warm runs, off and on in turns


def adapt_cells(port, hk, cells, out_dir, held) -> dict:
    """Each cell adaptive off and on, each in a context of its own with
    an event log: a cold run of each (off first, cost-checked), its
    kernel calls held, its launches against the executor's log; then
    ADAPT_WARM_REPS warm runs of each in turns (off, on, ...), and for
    the first cell one profiled warm run of the adaptive one (busy
    share; the other cells' profiles were cut for the script's
    time).  On must record the
    cell's rewrite, off none; the rows of both and of numpy agree.  Per
    mode: cold and warm walls, NEED reads per run, launches, rewrites,
    the order_by stage's output bytes (``shuffle_bytes``)."""
    import torch
    from dryad_tpu_torch.utils.events import EventLog
    res = {}
    for i, (label, (tables, query, check, kind)) in enumerate(
            cells.items()):
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
        n0 = {m: len(logs[m].events) for m in ("off", "on")}
        for mode in ("off", "on") * ADAPT_WARM_REPS:
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
            sort_bytes = [e["out_bytes"]
                          for e in logs[mode].events[n0[mode]:]
                          if e["event"] == "stage_done"
                          and e["label"] == "orderby"]
            per[mode].update({
                "warm_walls_s": walls[mode],
                "warm_wall_mean_s": sum(walls[mode]) / len(walls[mode]),
                "need_reads_warm": reads[mode],
                "orderby_out_bytes": sort_bytes})
            if mode == "on" and i == 0:
                # one profiled warm run: the rewritten plan's
                prof = profile_path(lambda: run_app(
                    port, hk, lambda c: query(c, tables).collect(),
                    ctx=ctx)[:4], f"{label}_{mode}", out_dir, pack=False)
                per[mode].update({
                    "profiled_wall_s": prof["wall_s"],
                    "profiled_device_ms": prof["device_ms"],
                    "device_busy_share": prof.get("device_busy_share")})
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


def teragen_records(n: int, chunk: int):
    """``write_teragen``'s records made again, (keys, payload), without
    a store."""
    parts = [teragen_chunk(i, min(chunk, n - i * chunk))
             for i in range(-(-n // chunk))]
    return (np.concatenate([k for k, _ in parts]),
            np.concatenate([p for _, p in parts]))


def rows_digest(keys, pay) -> str:
    """sha256 of (keys, payload) in row order: two outputs with one
    digest hold the same rows in the same order."""
    h = hashlib.sha256(np.ascontiguousarray(keys).tobytes())
    h.update(np.ascontiguousarray(pay).tobytes())
    return h.hexdigest()


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


def stream_profile(run, label) -> dict:
    """Device time and busy share of one warm run, summed from the
    profiler's raw device events (a streamed PageRank launches hundreds
    of thousands of kernels, and building the per-op tables over them
    took most of phase 13's time), in a padded window
    (``padded_profile``: a window with a missing record is taken again,
    at most PROFILE_WINDOWS in all); a kernel the run launched that shows
    no device time fails.  ``run()``
    returns (table, launches, load_s, query_s)."""
    import torch
    from torch.profiler import ProfilerActivity
    prof, (_out, launches, load, query), pad = padded_profile(
        run, [ProfilerActivity.CUDA], label)
    by = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and e.correlation_id() not in pad):
            by[e.name()] += e.duration_ns() / 1e6
    ours = {k: sum(v for n, v in by.items()
                   if any(s in n for s in subs))
            for k, subs in DEVICE_NAMES.items()}
    missing = [k for k, n in launches.items() if n and not ours[k]]
    if missing:
        raise AssertionError(f"{label}: {missing} launched but show no "
                             f"profiled device time")
    total = sum(by.values())
    return {"wall_s": load + query, "device_ms": total,
            "device_busy_share": total / 1e3 / (load + query),
            "port_kernels_ms": ours,
            "top": [[k[:120], v] for k, v in by.most_common(6)]}


def _line(r: dict, rows: int) -> dict:
    """A run's printable numbers (no table, no captured calls)."""
    line = {k: v for k, v in r.items() if k not in ("out", "captured")}
    line["rows_per_s"] = rows / r["wall_s"]
    return line


def stream_cell(port, hk, ooc, label, app, check, config, rows, held,
                device="cuda", profile: bool = False) -> dict:
    """A phase-13 cell: a cold run (its kernel calls held, its host syncs
    counted, its result checked), a warm run (wall, copies, peak memory,
    checked) and, with ``profile``, one profiled warm run (device busy
    share).  ``cell_s``: the seconds the cell took, holds and profile
    included."""
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
    if device == "cuda" and profile:
        line["profiled"] = stream_profile(profiled, label)
    steps["profile_s"] = time.perf_counter() - t1
    line["cell_s"] = time.perf_counter() - t0
    line["steps"] = steps
    return line, cold, warm


def terasort_ooc_runs(port, hk, ooc, ts, sizes, tmp, held,
                      device="cuda", keep=None) -> dict:
    """terasortooc10m: TeraGen records written chunk by chunk, then
    ``read_store_stream(chunk_rows).order_by(key).to_store(out)``, read
    back and held (count, byte order, the input's multiset): ooc_inflight
    2 cold / warm / profiled (one depth: depth 1 ran as fast, the
    copies being pageable), the in-core tier once, the same
    depth-2 query at ``small_records`` (its peak device memory against the
    big run's), and the ``terasort_ooc`` app.  With ``keep`` (a dict) the
    two TeraGen stores stay for phase 20, and ``keep["tera"]`` holds their
    paths, the digest of the in-process sorted output and the head of
    the small one's."""
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
    inc = stream_run(port, hk, ooc, query(src), ooc_cfg(2, 1 << 30),
                     device)
    check(inc["out"])
    big_out = first["out"]
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
    check_terasort_store("terasort_ooc", ar["out"],
                         teragen_records(sizes.app_records, chunk))
    ar["sorts"] = [info]
    sort_launches("terasort_ooc", ar)
    res["app"] = {**_line(ar, sizes.app_records), "sort": info}
    if keep is not None:
        # digests and a head, not the 10M-record arrays: they would stay
        # in this process through phases 14-19
        keep["tera"] = {"src": src, "small": small, "chunk": chunk,
                        "records": sizes.records,
                        "out_digest": rows_digest(*big_out),
                        "small_records": len(sm["out"][1]),
                        "small_head": tuple(a[:STREAM_TAKE].copy()
                                            for a in sm["out"]),
                        "warm_wall_s": warm["wall_s"]}
    for p in ((out, app_out) if keep is not None
              else (src, small, out, app_out)):
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
                 device="cuda", keep=None) -> dict:
    """Phase 13's runs through the public streamed entry points, each
    held to its oracle (see the module docstring).  Stores and files live
    under ``tmp`` and are deleted.  Returns one line per cell, and under
    ``"scatter_calls"`` one captured scatter histogram per (run, ids,
    buckets): the sort's range scatter, PageRank's and k-means' hash
    scatters.  With ``keep`` (a dict) the stores and the text file that
    phase 20 streams again stay under ``tmp``, and ``keep`` holds their
    paths, oracles and the in-process runs' outputs and warm walls."""
    from dryad_tpu_torch.apps import kmeans as km
    from dryad_tpu_torch.apps import pagerank as pr
    from dryad_tpu_torch.apps import terasort as ts
    from dryad_tpu_torch.exec import ooc
    tera, scatter = terasort_ooc_runs(port, hk, ooc, ts, sizes, tmp,
                                      held, device, keep)
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
            n_iters=STREAM_PR_ITERS)

    # the float64 references, computed once for the cell's three checks
    pr_ref = types.SimpleNamespace(pagerank_numpy=lambda *_a, _r=(
        pr.pagerank_numpy(edges, sizes.nodes, STREAM_PR_ITERS)): _r)
    line, cold, warm = stream_cell(
        port, hk, ooc, "pagerankstream100k", pagerank,
        lambda out: check_pagerank(out, edges, sizes.nodes, pr_ref), cfg,
        len(edges["src"]) * STREAM_PR_ITERS, held, device)
    scatter.update(scatter_hist_calls("pagerankstream100k",
                                      cold.pop("captured"), (64,)))
    # the cold run writes the edges' entry and the out-degrees' once;
    # every pass of every superstep re-streams them
    hits = min(cold["cache_hits"], warm["cache_hits"])
    if cold["cache_writes"] != 2 or warm["cache_writes"] or \
            hits < 2 * STREAM_PR_ITERS:
        raise AssertionError(f"pagerankstream100k: cache events cold "
                             f"{cold['cache_writes']} writes / "
                             f"{cold['cache_hits']} hits, warm "
                             f"{warm['cache_writes']} / "
                             f"{warm['cache_hits']}")
    res["pagerankstream100k"] = {"edges": len(edges["src"]),
                                 "iters": STREAM_PR_ITERS,
                                 "chunk_rows": chunk,
                                 **line}
    if keep is not None:
        keep["pagerank"] = {"path": epath, "edges": edges, "ref": pr_ref,
                            "out": cold["out"], "chunk": chunk,
                            "nodes": sizes.nodes,
                            "warm_wall_s": warm["wall_s"]}
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
        line, _, warm = stream_cell(
            port, hk, ooc, f"q13stream1m5_{how}", q13(how),
            check_q13_stream, None, len(orders["okey"]), held,
            device)
        if keep is not None:
            keep.setdefault("q13", {"path": opath, "orders": orders,
                                    "cust": cust, "chunk": chunk,
                                    "check": check_q13_stream,
                                    "warm_wall_s": {}})
            keep["q13"]["warm_wall_s"][how] = warm["wall_s"]
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

    line, _, warm = stream_cell(port, hk, ooc, "readtextstream1m",
                                wordcount, check_wc, None, len(lines), held,
                                device)
    res["readtextstream1m"] = line
    res["scatter_calls"] = scatter
    if keep is not None:
        keep["text"] = {"path": tpath, "chunk": sizes.text_chunk,
                        "lines": len(lines), "check": check_wc,
                        "warm_wall_s": warm["wall_s"]}
    for name in (("points",) if keep is not None
                 else ("edges", "points", "orders", "bench12.txt")):
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
SQL_WARM_REPS = 1      # sqlq3's interleaved warm runs (bench.py:385-394)
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
    return _revenue_oracle(li["okey"], li["price"], li["qty"], flag)


@host_memo
def _revenue_oracle(okey, price, qty, flag: int):
    keep = okey % 2 == flag
    ok = okey[keep]
    v = price[keep].astype(np.float64) * qty[keep]
    nb = int(okey.max()) + 1
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
    keys, n, s, lo, hi, qualifying = _q1_oracle(li["qty"], li["price"])
    tol = 16 * EPS * s                       # prices are positive
    ok = (np.array_equal(np.asarray(out["qty"]), keys)
          and np.array_equal(np.asarray(out["n"]), n)
          and np.array_equal(np.asarray(out["lo"]), lo)
          and np.array_equal(np.asarray(out["hi"]), hi)
          and (np.abs(np.asarray(out["s"], np.float64) - s) <= tol).all()
          and (np.abs(np.asarray(out["a"], np.float64) - s / n)
               <= tol / n).all())
    if not ok:
        raise AssertionError(f"{label}: the aggregate differs from numpy")
    return {"rows": len(keys), "qualifying": qualifying}


@host_memo
def _q1_oracle(qty, price):
    """SQL_Q1's groups over the rows whose tag is not ``void`` (every
    third row): keys, counts, float64 sums, min and max, the rows."""
    mask = np.arange(len(qty)) % 3 != 0
    q, p = qty[mask], price[mask]
    keys = np.unique(q)
    return (keys, np.bincount(q)[keys],
            np.bincount(q, weights=p.astype(np.float64))[keys],
            np.array([p[q == x].min() for x in keys]),
            np.array([p[q == x].max() for x in keys]), int(mask.sum()))


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
    ``out_dir``, one profiled warm run of the off cell: device time and
    busy share), the two committed golden queries and the Q1-shaped aggregate
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
        if out_dir is not None and mode == "off":
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

OBS_REPS = 1             # warm PageRank runs with telemetry off and on each
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
    inside its predicted rows and its predicted bytes (a stage fed the
    rescaled join's capacity is predicted at that capacity,
    ``obs/analyze.py``); zero ``cost_model_miss``; and the join stage's
    unsalted retry (2 runs, 1 retry)."""
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
    checked = [st for st in settled
               if st["scale"] == 1 and st["pred_rows"] is not None]
    unbounded = [st["stage"] for st in checked if not st["rows_in_bounds"]
                 or not st["bytes_in_bounds"]]
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
            "stages": [{k: st[k] for k in (
                "stage", "label", "runs", "retries", "rows", "out_bytes",
                "pred_rows", "pred_bytes", "rows_in_bounds",
                "bytes_in_bounds", "scale", "wall_s", "compile_s")}
                for st in rep["stages"]]}


def _subtree(spans, root) -> list:
    """``root`` and every span below it."""
    kids = {}
    for s in spans:
        kids.setdefault(s.get("parent"), []).append(s)
    out, todo = [], [root]
    while todo:
        s = todo.pop()
        out.append(s)
        todo.extend(kids.get(s["span"], ()))
    return out


def _run_of(span, by_id):
    """The nearest ``run`` (kind ``job``) span above ``span``."""
    up = by_id.get(span.get("parent"))
    while up is not None and up["kind"] != "job":
        up = by_id.get(up.get("parent"))
    return up


def check_telemetry(label, log, runs, device) -> dict:
    """One telemetry-on run's events: per executor run one ``run`` job
    span, and a ``stage`` span for each stage the run computed, every
    one below that job span with no other job span between (the
    program's own spans, ``op.*``, ``exchange.*``, ``settle`` and the
    rest, nest between and below them); one ``job_done`` per run
    carrying the job span's trace id and the metrics snapshot; at least
    one ``resource_sample``, with ``0 < device_bytes <=
    torch.cuda.max_memory_allocated()`` on the card; and the critical
    path of each run's spans covering its job span's wall (segments
    summing to it)."""
    import torch

    from dryad_tpu_torch.obs.critical_path import critical_path
    spans = log.of_type("span")
    by_id = {s["span"]: s for s in spans}
    jobs = [s for s in spans if s["kind"] == "job"]
    done = log.of_type("job_done")
    errors = []
    if len(jobs) != len(runs) or len(done) != len(runs):
        errors.append(f"{len(jobs)} job spans and {len(done)} job_done for "
                      f"{len(runs)} runs")
    worst = 0.0
    for job, r, d in zip(jobs, runs, done):
        mine = _subtree(spans, job)
        st = [s for s in mine if s["kind"] == "stage"]
        if (any(s["trace"] != job["trace"] for s in mine)
                or any(_run_of(s, by_id) is not job for s in st)
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
    extra = [k for k in launches
             if seen[k] > launches[k] * KERNELS_A_CALL.get(k, 1)]
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
# phase 16: incremental queries over a growing store, and the network stores


INC_Q1 = ("SELECT qty, COUNT(*) AS n, SUM(qty) AS sq, SUM(price) AS s, "
          "AVG(price) AS a, MIN(price) AS lo, MAX(price) AS hi "
          "FROM lineitem WHERE tag != 'void' GROUP BY qty EMIT EVERY 1")
INC_OKEY = ("SELECT okey, COUNT(*) AS n, SUM(qty) AS sq, MIN(price) AS lo, "
            "MAX(price) AS hi FROM lineitem GROUP BY okey EMIT EVERY 1")
INC_APPEND = ("SELECT okey, qty, price FROM lineitem WHERE tag = 'ok' "
              "EMIT EVERY 1")
INC_ROUNDS = 2
INC_SCALE = 4     # phase 16 runs on --lineitems / INC_SCALE (SF 0.25): cut
                  # for the script's time
INC_SMALL = 200_000        # inc_modes' store (the DTA403 rebuild)
TAG_LEN = 8                # the stores' tag width (tags are 2-4 bytes)
REMOTE_CHUNK = 1 << 19     # rows a chunk of the streamed hdfs:// read
TEXT_PARTS = 4             # bench12's text as this many remote files
S3_PART_BYTES = 8 << 20    # remote_s3_6m's multipart part size


def rf1_batch(n_items: int, rnd: int, seed: int = 16) -> dict:
    """TPC-H RF1 at the lineitems' scale factor (SF = n_items /
    6,000,000): SF x 1,500 new orders (0.1 % of ORDERS), each with 1-7
    lineitems, their order keys following the existing ones (round
    ``rnd`` after ``rnd`` earlier batches); ``price`` f32 in [1, 100),
    ``qty`` in [1, 10), every third row's tag ``b"void"``."""
    rng = np.random.RandomState(seed + rnd)
    n_new = max(1, round(1_500 * n_items / 6_000_000))
    first = n_items // 4 + rnd * n_new
    per = rng.randint(1, 8, n_new)
    n = int(per.sum())
    return {"okey": np.repeat(np.arange(first, first + n_new,
                                        dtype=np.int32), per),
            "price": rng.randint(1, 100, n).astype(np.float32),
            "qty": rng.randint(1, 10, n).astype(np.int32),
            "tag": ([b"void", b"ok", b"ok"] * (n // 3 + 1))[:n]}


def _concat_tables(a: dict, b: dict) -> dict:
    return {k: (list(a[k]) + list(b[k]) if isinstance(a[k], list)
                else np.concatenate([a[k], b[k]])) for k in a}


def _by_key(out: dict, key: str) -> dict:
    """{group key: {column: value}} of a collected table."""
    cols = [c for c in out if c != key]
    return {k: {c: out[c][i] for c in cols}
            for i, k in enumerate(np.asarray(out[key]).tolist())}


def check_inc_round(label, got: dict, full: dict, key: str, f32: tuple,
                    scale: dict) -> None:
    """An incremental refresh's table against the full rescan's: the same
    groups, every column bit-equal but those in ``f32``, which lie within
    16 eps x ``scale[group]`` (sum |v| of the group's values; a mean's
    bound over the group's count)."""
    g, w = _by_key(got, key), _by_key(full, key)
    if set(g) != set(w):
        raise AssertionError(f"{label}: groups differ "
                             f"({len(g)} against {len(w)})")
    for k, row in w.items():
        for c, v in row.items():
            x = g[k][c]
            if c in f32:
                tol = 16 * EPS * scale[k] / (row["n"] if c == "a" else 1)
                if not abs(float(x) - float(v)) <= tol:
                    raise AssertionError(f"{label}: {key}={k} {c} {x} vs "
                                         f"{v} (bound {tol})")
            elif np.asarray(x).tobytes() != np.asarray(v).tobytes():
                raise AssertionError(f"{label}: {key}={k} {c} {x} != {v}")


def inc_store(port, li: dict, path: str, device: str) -> None:
    """The lineitems as a local store of NPARTS partitions."""
    port.Context(device=device, nparts=NPARTS).from_columns(
        li, str_max_len=TAG_LEN).to_store(path)


def inc_append(port, path: str, batch: dict, device: str) -> int:
    """One append of ``batch`` as ONE new store partition."""
    from dryad_tpu_torch.io.store import append_store
    ds = port.Context(device=device, nparts=1).from_columns(
        batch, str_max_len=TAG_LEN)
    return append_store(path, ds.node.data)


def inc_refresh(port, hk, ctx, sql, cat, text, state_dir, label, held,
                device):
    """One ``run_refresh`` through ``run_app`` (kernel calls held):
    (result, launches, seconds)."""
    from dryad_tpu_torch.inc import run_refresh
    bound = sql.compile_query(cat, text)[1]
    hk.capture = {}
    res, launches, load, qs, _runs = run_app(
        port, hk, lambda c: run_refresh(c, cat, bound,
                                        sql.normalize_query(text),
                                        state_dir), device, ctx=ctx)
    captured, hk.capture = hk.capture, None
    held(label, launches, captured)
    return res, launches, load + qs


def inc_full(port, hk, ctx, sql, cat, text, device):
    """The same statement as one batch query (``sql.query`` runs an EMIT
    EVERY statement once): (table, seconds)."""
    out, _l, load, qs, _r = run_app(
        port, hk, lambda c: sql.query(c, cat, text).collect(), device,
        ctx=ctx)
    return out, load + qs


def inc_runs(port, hk, li: dict, tmp: str, held, device="cuda") -> dict:
    """inc_q1_6m and inc_okey_6m: the lineitems as a local store of
    NPARTS partitions, one first refresh of each standing query (its
    state from the full scan), then INC_ROUNDS rounds of one RF1-sized
    ``append_store`` (one partition), ``run_refresh`` and the full
    ``sql.query`` of the same statement, held to each other: Q1's
    integer columns bit-equal, ``s`` and ``a`` within 16 eps sum |price|
    of the group; every okey column bit-equal; each refresh
    incremental, one delta partition of exactly the appended rows."""
    from dryad_tpu_torch import sql
    from dryad_tpu_torch.io.store import store_meta
    path = os.path.join(tmp, "lineitem")
    inc_store(port, li, path, device)
    cat = sql.Catalog().register_store("lineitem", path)
    ctx = port.Context(device=device, nparts=NPARTS)
    cells = {"inc_q1_6m": (INC_Q1, "qty", ("s", "a")),
             "inc_okey_6m": (INC_OKEY, "okey", ())}
    out = {label: {"rounds": []} for label in cells}
    rows = li
    for label, (text, _key, _f) in cells.items():
        res, launches, wall = inc_refresh(
            port, hk, ctx, sql, cat, text, os.path.join(tmp, label),
            f"{label}_r0", held, device)
        out[label]["first"] = {"mode": res.mode, "wall_s": wall,
                               "state_rows": res.rows,
                               "launches": launches}
    for rnd in range(INC_ROUNDS):
        batch = rf1_batch(len(li["okey"]), rnd)
        gen = inc_append(port, path, batch, device)
        rows = _concat_tables(rows, batch)
        scale = q1_scale(rows, void=False)
        for label, (text, key, f32) in cells.items():
            sd = os.path.join(tmp, label)
            res, launches, wall = inc_refresh(
                port, hk, ctx, sql, cat, text, sd,
                f"{label}_r{rnd + 1}", held, device)
            full, full_s = inc_full(port, hk, ctx, sql, cat, text, device)
            if (res.mode != "incremental" or len(res.delta_parts) != 1
                    or res.delta_rows != len(batch["okey"])
                    or res.generation != gen):
                raise AssertionError(
                    f"{label} round {rnd + 1}: {res.mode}, delta "
                    f"{res.delta_parts} / {res.delta_rows} rows, appended "
                    f"{len(batch['okey'])} at generation {gen}")
            check_inc_round(f"{label} round {rnd + 1}", res.table, full,
                            key, f32, scale)
            (sp,) = [os.path.join(sd, f) for f in os.listdir(sd)]
            out[label]["rounds"].append({
                "appended": len(batch["okey"]), "generation": gen,
                "incremental_s": wall, "full_s": full_s,
                "merge_s": res.merge_s, "state_rows": res.rows,
                "state_bytes": os.path.getsize(sp),
                "changed_rows": res.changed_rows, "launches": launches})
    meta = store_meta(path)
    for label in cells:
        out[label].update(store_rows=sum(meta["counts"]),
                          store_parts=meta["npartitions"])
    shutil.rmtree(path)
    return out


def q1_scale(rows: dict, void: bool) -> dict:
    """{qty: sum |price|} over ``rows`` (without the ``void`` rows unless
    ``void``): the f32 bound's scale of each group."""
    keep = (np.ones(len(rows["qty"]), bool) if void else
            np.asarray([t != b"void" for t in rows["tag"]]))
    return {int(q): float(np.abs(rows["price"][keep
                                               & (rows["qty"] == q)]).sum())
            for q in np.unique(rows["qty"])}


def inc_modes(port, hk, li: dict, tmp: str, held, device="cuda") -> dict:
    """inc_modes over the first INC_SMALL lineitems as a local store:
    DTA402 (Q1 with its ORDER BY reruns every round: ``rescan``, rows
    equal to ``sql.query``'s); the append shape (INC_APPEND emits exactly
    the appended batch's ``tag = 'ok'`` rows); a crash (``commit_state``
    raises once in round 2: state file and watermark unchanged, and the
    retry counts that delta once, equal to the full query); a ``noop``
    refresh with nothing appended; and DTA403 (an append larger than the
    store rebuilds, equal to the full query)."""
    from dryad_tpu_torch import sql
    from dryad_tpu_torch.inc import run_refresh
    from dryad_tpu_torch.inc import state as inc_state
    from dryad_tpu_torch.inc.refresh import table_payload
    from dryad_tpu_torch.io.store import store_meta
    path = os.path.join(tmp, "small")
    small = {k: v[:INC_SMALL] for k, v in li.items()}
    inc_store(port, small, path, device)
    cat = sql.Catalog().register_store("lineitem", path)
    ctx = port.Context(device=device, nparts=NPARTS)
    sd = os.path.join(tmp, "modes")
    order_q = SQL_Q1 + " EMIT EVERY 1"
    agg = INC_Q1.replace("WHERE tag != 'void' ", "")
    agg_bound = sql.compile_query(cat, agg)[1]
    sp = inc_state.state_path(sd, inc_state.state_key(
        sql.normalize_query(agg), "lineitem", path,
        store_meta(path)["schema"]))
    out = {"store_rows": INC_SMALL, "rounds": []}

    def rows(t):
        pay = table_payload(t)["table"]
        return sorted(zip(*[pay[c] for c in sorted(pay)]))

    def agg_round(label, rows_now, mode):
        res, _l, wall = inc_refresh(port, hk, ctx, sql, cat, agg, sd,
                                    label, held, device)
        full, _s = inc_full(port, hk, ctx, sql, cat, agg, device)
        if res.mode != mode:
            raise AssertionError(f"{label}: {res.mode}, not {mode}")
        check_inc_round(label, res.table, full, "qty", ("s", "a"),
                        q1_scale(rows_now, void=True))
        return res, wall

    for text in (order_q, INC_APPEND, agg):
        inc_refresh(port, hk, ctx, sql, cat, text, sd, "inc_modes_r0",
                    held, device)
    now = small
    for rnd in range(INC_ROUNDS):
        batch = rf1_batch(INC_SMALL, rnd)
        inc_append(port, path, batch, device)
        now = _concat_tables(now, batch)
        res, _l, dta402_s = inc_refresh(
            port, hk, ctx, sql, cat, order_q, sd,
            f"inc_modes_dta402_r{rnd + 1}", held, device)
        full, _s = inc_full(port, hk, ctx, sql, cat, SQL_Q1, device)
        if (res.mode, res.code) != ("rescan", "DTA402") \
                or rows(res.table) != rows(full):
            raise AssertionError(f"inc_modes DTA402 round {rnd + 1}: "
                                 f"{res.mode} {res.code}")
        res, _l, _w = inc_refresh(port, hk, ctx, sql, cat, INC_APPEND, sd,
                                  f"inc_modes_append_r{rnd + 1}", held,
                                  device)
        ok = np.asarray([t == b"ok" for t in batch["tag"]])
        want = sorted(zip(batch["okey"][ok].tolist(),
                          batch["price"][ok].tolist(),
                          batch["qty"][ok].tolist()))
        if res.mode != "incremental" or rows(res.table) != want:
            raise AssertionError(f"inc_modes append round {rnd + 1}: "
                                 f"{res.mode}, {res.rows} rows, want "
                                 f"{len(want)}")
        crashed = False
        if rnd == 1:
            before = open(sp, "rb").read()
            real = inc_state.commit_state

            def crash(*a, **kw):
                raise OSError("commit_state: simulated crash")

            inc_state.commit_state = crash
            try:
                run_refresh(ctx, cat, agg_bound, sql.normalize_query(agg),
                            sd)
            except OSError:
                crashed = True
            finally:
                inc_state.commit_state = real
            if (not crashed or open(sp, "rb").read() != before
                    or inc_state.load_state(sp)[0]
                    != cat.watermark("lineitem") - 1):
                raise AssertionError("inc_modes: the crashed refresh "
                                     "changed the committed state")
        res, _w = agg_round(f"inc_modes_agg_r{rnd + 1}", now,
                            "incremental")
        if len(res.delta_parts) != 1 or res.delta_rows != len(
                batch["okey"]):
            raise AssertionError(f"inc_modes round {rnd + 1}: delta "
                                 f"{res.delta_parts} / {res.delta_rows}")
        out["rounds"].append({"appended": len(batch["okey"]),
                              "crashed_first": crashed,
                              "dta402_s": dta402_s})
    res, _l, noop_s = inc_refresh(port, hk, ctx, sql, cat, agg, sd,
                                  "inc_modes_noop", held, device)
    if res.mode != "noop" or res.delta_parts or res.changed_rows:
        raise AssertionError(f"inc_modes noop: {res.mode}")
    big = {k: v[INC_SMALL:INC_SMALL + INC_SMALL + INC_SMALL // 4]
           for k, v in li.items()}
    inc_append(port, path, big, device)
    res, rebuild_s = agg_round("inc_modes_dta403", _concat_tables(now, big),
                               "rebuild")
    if res.code != "DTA403":
        raise AssertionError(f"inc_modes DTA403: {res.code}")
    out.update(noop_s=noop_s, rebuild={"appended": len(big["okey"]),
                                       "wall_s": rebuild_s,
                                       "scanned_parts": len(
                                           res.delta_parts)})
    shutil.rmtree(path)
    return out


def loopback_fakes():
    """(``tests/torch_fakes``, ``tests/webhdfs_fake``) of this checkout,
    imported by path: another ``tests`` package on the machine may shadow
    the checkout's directory."""
    d = os.path.join(HERE, "tests")
    if d not in sys.path:
        sys.path.insert(0, d)
    import torch_fakes
    import webhdfs_fake
    for m in (torch_fakes, webhdfs_fake):
        if os.path.dirname(os.path.abspath(m.__file__)) != d:
            raise RuntimeError(f"{m.__name__} imported from {m.__file__}")
    return torch_fakes, webhdfs_fake


def _sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def remote_wordcount(port, hk, wc, uri, n_lines, label, held, device,
                     **kw):
    """WordCount over ``ctx.read(uri)`` (96-byte lines, as phase 3 loads
    bench12) through ``run_app``, kernel calls held: (counts, seconds)."""
    per_part = -(-n_lines // NPARTS)
    hk.capture = {}
    out, launches, load, qs, _r = run_app(
        port, hk, lambda c: wc.wordcount_query(
            c.read(uri, max_line_len=96, **kw),
            tokens_per_partition=per_part * 10).collect(), device)
    captured, hk.capture = hk.capture, None
    held(label, launches, captured)
    return dict(zip(out["line"], (int(v) for v in out["n"]))), load + qs


def remote_q1(port, hk, sql, path, label, held, device):
    """SQL_Q1 over the store at ``path`` through ``run_app`` (kernel calls
    held): (table, seconds)."""
    cat = sql.Catalog().register_store("lineitem", path)
    hk.capture = {}
    out, launches, load, qs, _r = run_app(
        port, hk, lambda c: sql.query(c, cat, SQL_Q1).collect(), device)
    captured, hk.capture = hk.capture, None
    held(label, launches, captured)
    return out, load + qs


def _same_table(label, got, want) -> None:
    for k in want:
        if np.asarray(got[k]).tobytes() != np.asarray(want[k]).tobytes():
            raise AssertionError(f"{label}: column {k} differs from the "
                                 f"local store's")


def text_parts(lines) -> list:
    """bench12's lines as TEXT_PARTS newline-terminated files' bytes."""
    per = -(-len(lines) // TEXT_PARTS)
    return [("\n".join(lines[i:i + per]) + "\n").encode()
            for i in range(0, len(lines), per)]


def store_write_read(port, li, url, device) -> dict:
    """``to_store`` of the lineitems at ``url``, then ``read_store`` of it:
    seconds and rates over the store's payload bytes."""
    from dryad_tpu_torch.io.store import read_store, store_meta
    ctx = port.Context(device=device, nparts=NPARTS)
    ds = ctx.from_columns(li, str_max_len=TAG_LEN)
    _sync(device)
    t0 = time.perf_counter()
    ds.to_store(url)
    write_s = time.perf_counter() - t0
    nbytes = sum(store_meta(url)["bytes"])
    t0 = time.perf_counter()
    read_store(url, ctx.mesh)
    _sync(device)
    read_s = time.perf_counter() - t0
    return {"store_bytes": nbytes, "write_s": write_s, "read_s": read_s,
            "write_gbps_loopback": nbytes / write_s / 1e9,
            "read_gbps_loopback": nbytes / read_s / 1e9}


def remote_s3(port, hk, wc, sql, li, local, q1_local, lines, want, held,
              device="cuda") -> dict:
    """remote_s3_6m on ``tests/torch_fakes.FakeS3`` (loopback; every
    request's SigV4 signature verified): the lineitems written to
    ``s3://`` with multipart puts (8 MiB parts) and read back, SQL_Q1
    over it equal to the local store's table, ``ctx.read("s3://...")`` of
    bench12's text counted by WordCount equal to phase 3's counts."""
    from dryad_tpu_torch.io import s3_store
    from dryad_tpu_torch.io.s3 import S3Client
    FakeS3 = loopback_fakes()[0].FakeS3
    keep_env, keep_client = dict(os.environ), s3_store._CLIENT
    with FakeS3() as fake:
        try:
            os.environ.update(fake.environ())
            s3_store._CLIENT = S3Client(fake.config(
                multipart_bytes=S3_PART_BYTES))
            url = "s3://bkt/lineitem"
            line = store_write_read(port, li, url, device)
            out, q1_s = remote_q1(port, hk, sql, url, "remote_s3_q1", held,
                                  device)
            _same_table("remote_s3_6m Q1", out, q1_local)
            for i, blob in enumerate(text_parts(lines)):
                s3_store._CLIENT.put_object("bkt", f"text/part-{i}.txt",
                                            blob)
            got, wc_s = remote_wordcount(port, hk, wc, "s3://bkt/text/",
                                         len(lines), "remote_s3_text", held,
                                         device)
        finally:
            os.environ.clear()
            os.environ.update(keep_env)
            s3_store._CLIENT = keep_client
        if got != want:
            raise AssertionError("remote_s3_6m: WordCount over s3:// "
                                 "differs from the in-memory run")
        if fake.bad_auth or not fake.uploads:
            raise AssertionError(f"remote_s3_6m: {len(fake.bad_auth)} "
                                 f"refused signatures, {len(fake.uploads)} "
                                 f"multipart uploads")
        return {**line, "q1_s": q1_s, "wordcount_s": wc_s,
                "multipart_uploads": len(fake.uploads),
                "requests": len(fake.requests), "signatures_refused": 0,
                "rates": "loopback"}


def remote_hdfs(port, hk, wc, sql, li, local, q1_local, lines, want, held,
                device="cuda") -> dict:
    """remote_hdfs_6m on ``tests/webhdfs_fake.FakeWebHdfs`` (loopback):
    ``to_store`` / ``from_store`` over ``hdfs://`` (SQL_Q1 equal to the
    local store's table); ``read_store_stream`` by ranged reads
    (``ChunkSource.RANGED_STREAM_MIN_BYTES`` set to the smallest
    partition's bytes) grouped by qty, equal to the same over the local
    store; a streamed ``to_store`` to ``hdfs://`` equal to the same to a
    local path; ``ctx.read("hdfs://...")`` of bench12's text counted by
    WordCount equal to phase 3's counts."""
    from dryad_tpu_torch.exec.ooc import ChunkSource
    from dryad_tpu_torch.io.store import store_meta
    from dryad_tpu_torch.io.webhdfs import hdfs_client
    FakeWebHdfs = loopback_fakes()[1].FakeWebHdfs

    def streamed(c, path):
        return c.read_store_stream(path, chunk_rows=REMOTE_CHUNK).group_by(
            ["qty"], {"n": ("count", None), "s": ("sum", "price"),
                      "k": ("max", "okey")}).collect()

    def small(c, src, dst):
        c.read_store_stream(src, chunk_rows=REMOTE_CHUNK).where(
            lambda t: t["qty"] < 3).to_store(dst)
        back = c.from_store(dst).collect()
        order = np.lexsort((back["price"], back["qty"], back["okey"]))
        return {k: np.asarray(back[k])[order]
                for k in ("okey", "qty", "price")}

    srv = FakeWebHdfs(block_size=64 << 20)
    keep = ChunkSource.RANGED_STREAM_MIN_BYTES
    try:
        url = srv.url + "/stores/lineitem"
        line = store_write_read(port, li, url, device)
        out, q1_s = remote_q1(port, hk, sql, url, "remote_hdfs_q1", held,
                              device)
        _same_table("remote_hdfs_6m Q1", out, q1_local)
        ranged_min = min(store_meta(url)["bytes"])
        ChunkSource.RANGED_STREAM_MIN_BYTES = ranged_min
        before = len(srv.datanode_hits)
        hk.capture = {}
        got, launches, load, qs, _r = run_app(
            port, hk, lambda c: streamed(c, url), device)
        captured, hk.capture = hk.capture, None
        held("remote_hdfs_stream", launches, captured)
        stream_s = load + qs
        opens = [q for m, _p, q in srv.datanode_hits[before:]
                 if q.get("op") == "OPEN"]
        ChunkSource.RANGED_STREAM_MIN_BYTES = keep
        ctx = port.Context(device=device, nparts=NPARTS)
        _same_table("remote_hdfs_6m stream", got, streamed(ctx, local))
        if len(opens) < NPARTS * 5 or not all("length" in q for q in opens):
            raise AssertionError(f"remote_hdfs_6m: {len(opens)} ranged "
                                 f"reads")
        t0 = time.perf_counter()
        remote_small = small(ctx, local, srv.url + "/stores/small")
        streamed_write_s = time.perf_counter() - t0
        _same_table("remote_hdfs_6m streamed write", remote_small,
                    small(ctx, local, local + "_small"))
        shutil.rmtree(local + "_small")
        c, _p = hdfs_client(srv.url + "/")
        for i, blob in enumerate(text_parts(lines)):
            c.create(f"/text/part-{i}.txt", blob)
        got, wc_s = remote_wordcount(port, hk, wc, srv.url + "/text/",
                                     len(lines), "remote_hdfs_text", held,
                                     device)
        if got != want:
            raise AssertionError("remote_hdfs_6m: WordCount over hdfs:// "
                                 "differs from the in-memory run")
    finally:
        ChunkSource.RANGED_STREAM_MIN_BYTES = keep
        srv.close()
    return {**line, "q1_s": q1_s, "ranged_stream_min_bytes": ranged_min,
            "stream_s": stream_s, "ranged_reads": len(opens),
            "streamed_write_s": streamed_write_s,
            "streamed_write_rows": len(remote_small["okey"]),
            "wordcount_s": wc_s, "rates": "loopback"}


def remote_http(port, hk, wc, lines, want, held, device="cuda") -> dict:
    """remote_http_text on ``tests/torch_fakes.RangeServer`` (loopback):
    ``ctx.read("http://127.0.0.1:<port>/")`` enumerates bench12's text
    files and fetches them by 2 MiB ranged GETs; WordCount equal to phase
    3's counts."""
    RangeServer = loopback_fakes()[0].RangeServer
    files = {f"bench12-{i}.txt": b
             for i, b in enumerate(text_parts(lines))}
    with RangeServer(files) as web:
        got, wc_s = remote_wordcount(port, hk, wc, f"http://{web.base}/",
                                     len(lines), "remote_http_text", held,
                                     device)
        ranged = sum(1 for _p, r in web.requests if r)
    if got != want:
        raise AssertionError("remote_http_text: WordCount over http:// "
                             "differs from the in-memory run")
    nbytes = sum(len(b) for b in files.values())
    return {"text_bytes": nbytes, "files": len(files),
            "ranged_gets": ranged, "wordcount_s": wc_s,
            "read_gbps_loopback_incl_wordcount": nbytes / wc_s / 1e9,
            "rates": "loopback"}


def phase16_runs(port, hk, wc, n_items: int, tmp: str, lines, want, held,
                 device="cuda") -> dict:
    """Phase 16's cells over ``sql_tables(n_items)``'s lineitems (``tag``
    as an 8-byte string): the remote stores first (remote_s3_6m,
    remote_hdfs_6m against a local store of the same rows,
    remote_http_text), then the incremental cells (inc_q1_6m,
    inc_okey_6m, inc_modes), each store under ``tmp``."""
    from dryad_tpu_torch import sql
    li, _orders = sql_tables(n_items)
    local = os.path.join(tmp, "local")
    inc_store(port, li, local, device)
    q1_local, _s = remote_q1(port, hk, sql, local, "remote_local_q1", held,
                             device)
    res = {"remote_s3_6m": remote_s3(port, hk, wc, sql, li, local, q1_local,
                                     lines, want, held, device),
           "remote_hdfs_6m": remote_hdfs(port, hk, wc, sql, li, local,
                                         q1_local, lines, want, held,
                                         device),
           "remote_http_text": remote_http(port, hk, wc, lines, want, held,
                                           device)}
    shutil.rmtree(local)
    res.update(inc_runs(port, hk, li, tmp, held, device))
    res["inc_modes"] = inc_modes(port, hk, li, tmp, held, device)
    return res


# ---------------------------------------------------------------------------
# phase 17: the job service on the in-process fleet

# the same queries in another form: aliases renamed, SELECT lists
# shuffled, predicate operands swapped (one semantic fingerprint each)
SQL_Q1_ALT = ("SELECT MAX(t.price) AS hi, t.qty, AVG(t.price) AS a, "
              "COUNT(*) AS n, MIN(t.price) AS lo, SUM(t.price) AS s "
              "FROM lineitem t WHERE 'void' != t.tag GROUP BY t.qty "
              "ORDER BY qty")
SQL_Q3_ALT = ("SELECT COUNT(*) AS n, x.okey, SUM(x.qty * x.price) AS revenue "
              "FROM lineitem x JOIN orders y ON y.okey = x.okey "
              "WHERE y.flag = 0 GROUP BY x.okey ORDER BY revenue DESC "
              "LIMIT 10")
SVC_SHARES = {"dash": 2.0, "adhoc": 1.0, "batch": 1.0}
SVC_WC_JOBS = 2
SVC_SCALE = 4     # svc_durable_6m, svc_standing_6m and svc_http run on the
                  # lineitems / SVC_SCALE: cut for the script's time
SVC_WC_LINES = 500_000
SVC_WAIT_S = 900.0


def svc_table(res: dict) -> dict:
    """A SQL job's JSON result as numpy columns (for the phase-14
    checks)."""
    return {k: np.asarray(v) for k, v in res["table"].items()}


def svc_done(svc, jid, label) -> dict:
    """The job's final row; a job that did not finish fails the run."""
    row = svc.wait(jid, timeout=SVC_WAIT_S)
    if row["state"] != "done":
        raise AssertionError(f"{label}: job {jid} {row['state']}: "
                             f"{(row.get('error') or '')[-2000:]}")
    return row


SVC_HOLD_BYTES = 6 << 30      # a cell's captured kernel inputs, at most


class BoundedCapture(dict):
    """``hopper_kernels.capture`` for a cell whose jobs overlap on fleet
    threads: a kernel's calls are recorded while their input tensors
    hold at most ``budget`` bytes in all (each kernel's first call
    always), the rest only counted in ``dropped``; a capture of every
    call of twelve 6,000,000-row SQL jobs would hold the card's memory.
    The wrappers append under ``hopper_kernels``' count lock, so the
    threads' appends and ``left`` stay consistent."""

    def __init__(self, budget: int):
        super().__init__()
        self.left, self.dropped = budget, 0

    def setdefault(self, name, default=None):
        calls = self.get(name)
        if calls is None:
            calls = dict.setdefault(self, name, _BoundedCalls(self))
        return calls


class _BoundedCalls(list):
    def __init__(self, owner: BoundedCapture):
        super().__init__()
        self.owner = owner

    def append(self, call) -> None:
        nbytes = sum(a.numel() * a.element_size() for a in call[1]
                     if hasattr(a, "element_size"))
        if self and nbytes > self.owner.left:
            self.owner.dropped += 1
            return
        self.owner.left -= nbytes
        super().append(call)


def svc_cell(hk, label, held, fn):
    """Run one phase-17 cell ``fn()`` with the launch counters zeroed
    just before and read just after, its kernel calls captured within
    SVC_HOLD_BYTES (``BoundedCapture``) and held: (fn's line, launches,
    calls held and not held, seconds)."""
    import torch
    hk.capture = BoundedCapture(SVC_HOLD_BYTES)
    hk.reset_launches()
    t0 = time.perf_counter()
    try:
        line = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        captured, hk.capture = hk.capture, None
    seconds = time.perf_counter() - t0
    launches = dict(hk.launches)
    held(label, launches, captured)
    return {**line, "launches": launches, "wall_s": seconds,
            "held_calls": sum(len(c) for c in captured.values()),
            "unheld_calls": captured.dropped}


def svc_config(root, name, **kw):
    from dryad_tpu_torch.service import ServiceConfig, TenantQuota
    return ServiceConfig(
        service_dir=os.path.join(root, name),
        tenants={t: TenantQuota(share=s, max_queued_jobs=64)
                 for t, s in SVC_SHARES.items()}, **kw)


def svc_sql_6m(li, cat, root, q3_phase14_s, device) -> dict:
    """Three tenants (shares 2 / 1 / 1) submit SQL_Q1, SQL_Q3 and their
    equivalent forms in rounds to one JobService(slots=2); every result
    against numpy; DTA501 on the 10 equivalent submissions; one scan
    span per table, every other use shared; every job's events tagged
    with its own id.  Then one warm Q3 job, timed from submission to
    result."""
    from dryad_tpu_torch.service import JobService
    from dryad_tpu_torch.utils.events import EventLog
    checks = {"q1": lambda label, out: check_q1agg(label, out, li),
              "q3": lambda label, out: check_topk_revenue(label, out, li,
                                                           flag=0)}
    svc = JobService(svc_config(root, "sql", slots=2), device=device,
                     catalog=cat)
    try:
        jobs = []
        t0 = time.perf_counter()
        for text, kind in ((SQL_Q1, "q1"), (SQL_Q3, "q3"),
                           (SQL_Q1_ALT, "q1"), (SQL_Q3_ALT, "q3")):
            for tenant in SVC_SHARES:
                jobs.append((svc.submit_sql(text, tenant=tenant), kind))
        submit_s = time.perf_counter() - t0
        for jid, kind in jobs:
            checks[kind](f"svc_sql_6m {jid}",
                         svc_table(svc_done(svc, jid, "svc_sql_6m")["result"]))
        all_s = time.perf_counter() - t0
        for jid, _ in jobs:
            ev = svc.jobs[jid].log.events
            if not ev or any(e.get("job") != jid for e in ev):
                raise AssertionError(f"svc_sql_6m: {jid}'s log holds "
                                     f"another job's events")
        reuse = svc.log.of_type("reuse_verdict")
        spans = [e["name"] for e in svc.log.of_type("span")
                 if e.get("kind") == "io"]
        shared = collections.Counter(e["table"] for e in
                                     svc.log.of_type("scan_shared"))
        uses = {"lineitem": len(jobs), "orders": len(jobs) // 2}
        if (len(reuse) != len(jobs) - 2
                or any(r["code"] != "DTA501" for r in reuse)
                or sorted(spans) != ["scan lineitem", "scan orders"]
                or any(shared[t] + 1 != n for t, n in uses.items())):
            raise AssertionError(
                f"svc_sql_6m: {len(reuse)} DTA501 of {len(jobs) - 2}, io "
                f"spans {spans}, shared {dict(shared)} for uses {uses}")
        t1 = time.perf_counter()
        warm = svc.submit_sql(SQL_Q3, tenant="dash")
        checks["q3"]("svc_sql_6m warm", svc_table(
            svc_done(svc, warm, "svc_sql_6m")["result"]))
        warm_s = time.perf_counter() - t1
        lat = svc.latency_snapshot()
        shares = svc.admission.shares()
        waterfall = svc.jobs[warm].waterfall
    finally:
        svc.close()
    return {"jobs": len(jobs), "tenants": SVC_SHARES, "slots": 2,
            "dta501": len(reuse), "io_spans": spans,
            "scan_shared": dict(shared), "submit_s": submit_s,
            "all_done_s": all_s,
            "tenant_walls": {t: {"p50_s": r["p50_s"], "p95_s": r["p95_s"],
                                 "jobs": r.get("count")}
                             for t, r in lat.items()},
            "slot_s": {t: v[0] for t, v in shares.items()},
            "warm_q3_s": warm_s, "warm_q3_phases": waterfall.get("phases")
            if waterfall else None,
            "phase14_sqlq3_warm_s": q3_phase14_s}


def svc_wordcount(root, device) -> dict:
    """SVC_WC_JOBS wordcount app jobs (SVC_WC_LINES lines of 6 words,
    seeds 0, 1, ...) through the fleet, then the same jobs one after another
    without the service (the app's tasks, query and combine on one
    Context); both held to ``collections.Counter`` over the lines.
    Where the fleet's wall goes: ``submit_s``, the caller's thread until
    the six submissions returned (it makes and packs each job's lines),
    and ``fleet_phase_s``, the jobs' latency waterfalls summed by phase;
    the sequential leg's ``seq_pack_s`` (making the lines) and
    ``seq_query_s`` (query and combine)."""
    import torch
    from dryad_tpu_torch import Context
    from dryad_tpu_torch.service import APPS, JobService
    app = APPS["wordcount"]
    params = [{"n_lines": SVC_WC_LINES, "words_per_line": 6, "seed": s}
              for s in range(SVC_WC_JOBS)]
    svc = JobService(svc_config(root, "wc", slots=2), device=device)
    try:
        t0 = time.perf_counter()
        jids = [svc.submit("wordcount", p, tenant=t) for p, t in
                zip(params, list(SVC_SHARES) * SVC_WC_JOBS)]
        submit_s = time.perf_counter() - t0
        fleet = [svc_done(svc, j, "svc_wordcount")["result"] for j in jids]
        fleet_s = time.perf_counter() - t0
        phase_us = collections.Counter()
        for j in jids:
            for ph in svc.job(j).waterfall["phases"]:
                phase_us[ph["phase"]] += ph["us"]
    finally:
        svc.close()
    ctx = Context(device=device, nparts=NPARTS)
    seq, oracles = [], []
    seq_pack_s = 0.0
    t0 = time.perf_counter()
    for p in params:
        t1 = time.perf_counter()
        tasks = app.make_tasks(dict(p), NPARTS)
        cols = {k: [x for t in tasks for x in t[k]] for k in tasks[0]}
        seq_pack_s += time.perf_counter() - t1
        seq.append(app.combine([app.build_query(ctx, cols, p).collect()]))
        oracles.append(cols["line"])
    if device == "cuda":
        torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    for i, lines in enumerate(oracles):
        want = collections.Counter(itertools.chain.from_iterable(
            map(str.split, lines)))
        for how, got in (("fleet", fleet[i]), ("sequential", seq[i])):
            if got["words"] != dict(sorted(want.items())):
                raise AssertionError(f"svc_wordcount seed {i} ({how}): "
                                     f"counts differ from the Counter")
    return {"jobs": SVC_WC_JOBS, "lines": SVC_WC_LINES, "slots": 2,
            "fleet_s": fleet_s, "sequential_s": seq_s,
            "submit_s": submit_s,
            "fleet_phase_s": {k: v / 1e6 for k, v in phase_us.items()},
            "seq_pack_s": seq_pack_s, "seq_query_s": seq_s - seq_pack_s,
            "total_words": fleet[0]["total_words"],
            "word_counts": [f["words"] for f in fleet]}


def pause_after_first_stage(svc):
    """Make ``svc``'s jobs wait at their first settled (spilled and
    checkpointed) stage until their pause is set; returns an Event set
    there, so a ``handoff()`` lands exactly at that boundary."""
    import threading
    settled = threading.Event()
    durable_kw = svc._durable_run_kw

    def kw(job):
        out = durable_kw(job)
        ckpt = out["checkpoint"]

        def hook(run, sid):
            ckpt(run, sid)
            settled.set()
            job.pause.wait(SVC_WAIT_S)
        out["checkpoint"] = hook
        return out

    svc._durable_run_kw = kw
    return settled


def hold_after_first(svc) -> None:
    """Make every job of ``svc`` but the first wait, as its run starts,
    until its pause is set (a ``crash()`` sets it; the run then stops at
    its first stage boundary): a crash once the first job is done finds
    every other job queued or in flight, none finished."""
    durable_kw, first = svc._durable_run_kw, []

    def kw(job):
        if first and first[0] != job.id:
            job.pause.wait(SVC_WAIT_S)
        first[:] = first or [job.id]
        return durable_kw(job)

    svc._durable_run_kw = kw


def journal_charges(d) -> dict:
    with open(os.path.join(d, "durable", "journal.jsonl")) as f:
        return dict(collections.Counter(
            r["tenant"] for r in map(json.loads, f)
            if r.get("rec") == "tenant_charge"))


def svc_durable_6m(li, cat, root, device) -> dict:
    """Handoff: SQL_Q3 paused by ``handoff()`` after its first settled
    stage, resumed by a successor on the same directory from spill
    (``stage_restored`` for exactly the checkpoint's settled stages, the
    rest recomputed), rows against numpy.  Crash: four SQL jobs of two
    tenants on one slot, ``crash()`` once the first is done (the others
    held before they run, ``hold_after_first``); the successor resumes
    or re-admits the other three in ``seq`` order, every result against
    numpy, one tenant charge per job."""
    from dryad_tpu_torch.service import JobService
    q3 = lambda label, out: check_topk_revenue(label, out, li,  # noqa
                                               flag=0)
    q1 = lambda label, out: check_q1agg(label, out, li)  # noqa: E731
    cfg = svc_config(root, "handoff", slots=1, durable_spill=True)
    svc = JobService(cfg, device=device, catalog=cat)
    settled = pause_after_first_stage(svc)
    t0 = time.perf_counter()
    jid = svc.submit_sql(SQL_Q3, tenant="dash")
    if not settled.wait(SVC_WAIT_S):
        raise AssertionError("svc_durable_6m: no stage settled")
    first_s = time.perf_counter() - t0
    h = svc.handoff()
    jdir = svc.jobs[jid].dir
    with open(os.path.join(jdir, "checkpoint.json")) as f:
        ck = json.load(f)
    t1 = time.perf_counter()
    svc2 = JobService(cfg, device=device, catalog=cat)
    try:
        q3("svc_durable_6m resumed",
           svc_table(svc_done(svc2, jid, "svc_durable_6m")["result"]))
        resume_s = time.perf_counter() - t1
        ev = svc2.jobs[jid].log.events
        restored = sorted(e["stage"] for e in ev
                          if e["event"] == "stage_restored")
        computed = sorted(e["stage"] for e in ev
                          if e["event"] == "stage_done")
        if (h["paused"] != 1 or svc2.recovery["resumed"] != 1
                or restored != sorted(ck["settled"]) or not computed
                or set(computed) & set(restored)):
            raise AssertionError(
                f"svc_durable_6m: paused {h['paused']}, resumed "
                f"{svc2.recovery['resumed']}, restored {restored} of "
                f"settled {ck['settled']}, computed {computed}")
    finally:
        svc2.close()
    crash_cfg = svc_config(root, "crash", slots=1, durable_spill=True)
    svc = JobService(crash_cfg, device=device, catalog=cat)
    hold_after_first(svc)
    kinds = ((SQL_Q1, q1, "dash"), (SQL_Q3, q3, "adhoc"),
             (SQL_Q1_ALT, q1, "dash"), (SQL_Q3_ALT, q3, "adhoc"))
    jids = [svc.submit_sql(text, tenant=t) for text, _, t in kinds]
    svc_done(svc, jids[0], "svc_durable_6m crash")
    svc.crash()
    before = svc.admission.shares()
    t2 = time.perf_counter()
    svc2 = JobService(crash_cfg, device=device, catalog=cat)
    try:
        back = [e for e in svc2.log.events
                if e["event"] in ("job_resumed", "job_readmitted")]
        restored_ledger = svc2.admission.shares()
        for (text, check, _t), j in list(zip(kinds, jids))[1:]:
            check(f"svc_durable_6m {j}",
                  svc_table(svc_done(svc2, j, "svc_durable_6m")["result"]))
        recover_s = time.perf_counter() - t2
    finally:
        svc2.close()
    charges = journal_charges(crash_cfg.service_dir)
    if ([e["job"] for e in back] != jids[1:]
            or [e["seq"] for e in back] != sorted(e["seq"] for e in back)
            or charges != {"dash": 2, "adhoc": 2}
            or restored_ledger["dash"][0] < before["dash"][0]):
        raise AssertionError(f"svc_durable_6m crash: back {back}, "
                             f"charges {charges}")
    return {"handoff": {"first_stage_s": first_s, "paused": h["paused"],
                        "settled": ck["settled"], "restored": restored,
                        "recomputed": computed, "resume_s": resume_s},
            "crash": {"readmitted": [(e["job"], e["seq"], e["event"])
                                     for e in back],
                      "charges": charges, "recover_s": recover_s}}


def svc_standing_6m(port, li, n_items: int, root, device) -> dict:
    """INC_Q1 registered through ``submit_sql`` over a store of the
    lineitems (NPARTS partitions); after each of INC_ROUNDS RF1 appends
    the next refresh job's table against the full query (integers
    bit-equal, s and a within 16 eps sum |price|); then ``crash()``, one
    more append while the daemon is down, and the successor's first
    refresh scans exactly that append."""
    from dryad_tpu_torch import sql
    from dryad_tpu_torch.service import JobService
    path = os.path.join(root, "lineitem")
    inc_store(port, li, path, device)
    cat = sql.Catalog().register_store("lineitem", path)
    cfg = svc_config(root, "standing", slots=2)
    ctx = port.Context(device=device, nparts=NPARTS)
    svc = JobService(cfg, device=device, catalog=cat)

    def next_refresh(svc, sq, n, label):
        t0 = time.perf_counter()
        while sq.refreshes < n:
            if time.perf_counter() - t0 > SVC_WAIT_S:
                raise AssertionError(f"{label}: no refresh")
            time.sleep(0.01)
        (ev,) = [e for e in sq.log.events if e["event"] == "inc_refresh"
                 ][n - 1:n]
        # each refresh is one inc-refresh job of this service, in order
        job = sorted((j for j in svc.jobs.values()
                      if j.app == "inc-refresh"),
                     key=lambda j: j.seq)[n - 1]
        svc_done(svc, job.id, label)
        return ev, job.result, time.perf_counter() - t0

    rows, rounds = li, []
    try:
        sid = svc.submit_sql(INC_Q1, tenant="dash")
        sq = svc.standing.get(sid)
        first, _, first_s = next_refresh(svc, sq, 1, "svc_standing_6m")
        for rnd in range(INC_ROUNDS + 1):
            batch = rf1_batch(n_items, rnd)
            if rnd == INC_ROUNDS:
                svc.crash()
            gen = inc_append(port, path, batch, device)
            rows = _concat_tables(rows, batch)
            if rnd == INC_ROUNDS:
                svc = JobService(cfg, device=device, catalog=cat)
                sq = svc.standing.get(sid)
                n = 1
            else:
                n = rnd + 2
            label = f"svc_standing_6m round {rnd + 1}"
            ev, res, wait_s = next_refresh(svc, sq, n, label)
            t1 = time.perf_counter()
            full = sql.query(ctx, cat, INC_Q1).collect()
            full_s = time.perf_counter() - t1
            got = {k: np.asarray(v, np.asarray(full[k]).dtype)
                   for k, v in res["table"].items()}
            if (ev["mode"] != "incremental"
                    or ev["delta_rows"] != len(batch["okey"])
                    or ev["generation"] != gen):
                raise AssertionError(f"{label}: {ev['mode']}, "
                                     f"{ev['delta_rows']} rows at "
                                     f"{ev['generation']}, appended "
                                     f"{len(batch['okey'])} at {gen}")
            check_inc_round(label, got, full, "qty", ("s", "a"),
                            q1_scale(rows, void=False))
            rounds.append({"appended": len(batch["okey"]),
                           "generation": gen, "refresh_wait_s": wait_s,
                           "refresh_wall_s": ev.get("wall_s"),
                           "full_s": full_s,
                           "after_crash": rnd == INC_ROUNDS})
    finally:
        svc.close()
    shutil.rmtree(path)
    return {"standing": sid, "first_mode": first["mode"],
            "first_s": first_s, "rounds": rounds}


def svc_http(cat, li, root, device) -> dict:
    """``service.http.serve`` on loopback: SQL_Q1 by ``POST /sql``
    through ``Client``, its SSE stream followed to ``event: done``; the
    equivalent form by POST too (DTA501 and a shared scan); ``GET
    /metrics`` lists both families; one ``python -m
    dryad_tpu_torch.service submit --wait`` subprocess."""
    import threading

    from dryad_tpu_torch.obs.metrics import FAMILIES
    from dryad_tpu_torch.service import JobService
    from dryad_tpu_torch.service.http import Client, serve
    svc = JobService(svc_config(root, "http", slots=2), device=device,
                     catalog=cat)
    srv, port_ = serve(svc)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{port_}"
    try:
        cl = Client(url, timeout_s=SVC_WAIT_S)
        t0 = time.perf_counter()
        jid = cl.submit_sql(SQL_Q1, tenant="dash")
        frames = list(cl.stream_events(jid))
        kinds = [e["event"] for e in frames]
        row = cl.wait(jid, timeout=SVC_WAIT_S)
        sse_s = time.perf_counter() - t0
        check_q1agg("svc_http", svc_table(row["result"]), li)
        alt = cl.wait(cl.submit_sql(SQL_Q1_ALT, tenant="adhoc"),
                      timeout=SVC_WAIT_S)
        check_q1agg("svc_http alt", svc_table(alt["result"]), li)
        metrics = cl.metrics()
        names = [FAMILIES[k][0] for k in ("plan_reuse", "scan_shared")]
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "dryad_tpu_torch.service", "submit",
             "--url", url, "--sql", SQL_Q1, "--tenant", "batch", "--wait",
             "--timeout", str(SVC_WAIT_S)],
            cwd=HERE, capture_output=True, text=True,
            timeout=SVC_WAIT_S, env=dict(os.environ, PYTHONPATH=HERE))
        cli_s = time.perf_counter() - t1
        if proc.returncode != 0:
            raise AssertionError(f"svc_http: the CLI exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        cli = json.loads(proc.stdout)
        check_q1agg("svc_http cli", svc_table(cli["result"]), li)
        if (row["state"] != "done" or "job_submitted" not in kinds
                or "job_done" not in kinds or kinds[-1] != "job_archived"
                or any(e.get("job") != jid for e in frames)
                or not all(n in metrics for n in names)
                or cli["state"] != "done"):
            raise AssertionError(f"svc_http: {row['state']}, frames "
                                 f"{kinds[:5]}..., metrics names "
                                 f"{[n in metrics for n in names]}")
    finally:
        srv.shutdown()
        th.join(timeout=30)
        svc.close()
    return {"sse_frames": len(frames), "sse_job_s": sse_s,
            "metrics_families": names, "cli_s": cli_s}


def phase17_runs(port, hk, tables, n_items: int, root: str, held,
                 q3_phase14_s=None, device="cuda") -> dict:
    """Phase 17's cells (svc_sql_6m, svc_wordcount, svc_durable_6m,
    svc_standing_6m, svc_http), each service under ``root``; each cell's
    kernel calls held under its label.  svc_sql_6m runs over phase 14's
    ``sql_catalog`` triple ``tables`` (its warm Q3 beside phase 14's);
    the durable, standing and HTTP cells over a catalog of
    ``n_items // SVC_SCALE`` lineitems (their services load the table
    again at every restart)."""
    from dryad_tpu_torch import sql
    li, _orders, cat = tables
    n_small = n_items // SVC_SCALE
    sli, _sorders, scat = sql_catalog(sql, n_small)
    cells = {
        "svc_sql_6m": lambda: svc_sql_6m(li, cat, root, q3_phase14_s,
                                         device),
        "svc_wordcount": lambda: svc_wordcount(root, device),
        "svc_durable_6m": lambda: svc_durable_6m(sli, scat, root, device),
        "svc_standing_6m": lambda: svc_standing_6m(port, sli, n_small, root,
                                                   device),
        "svc_http": lambda: svc_http(scat, sli, root, device)}
    out = {label: svc_cell(hk, label, held, fn)
           for label, fn in cells.items()}
    for label in ("svc_durable_6m", "svc_standing_6m", "svc_http"):
        out[label]["lineitems"] = n_small
    return out


# ---------------------------------------------------------------------------
# phase 18: worker processes on the card (the task farm, the job service's
# cluster fleet, forensics) and the chaos harness

FARM_ROWS = 8_000_000
FARM_KEYS = 4096
FARM_TASKS = 16
CLUSTER_WORKERS = 2
STRAGGLER_S = 6.0          # the delay_hook straggler's one slow copy
KILL_DELAY_S = 3.0         # worker 1's tasks in the kill run...
KILL_AT_S = 1.0            # ...and the SIGKILL after its first dispatch
TESTS = os.path.join(HERE, "tests")
# one replayed task's captured kernel inputs, at most: the replays run
# one at a time, after the workers' runs, so a task's calls may pin more
# than a phase-17 cell's overlapping jobs could
REPLAY_HOLD_BYTES = 16 << 30


def worker_launches(events) -> dict:
    """The five kernels' launches the workers reported for a run's tasks
    (every copy's: ``task_done`` and ``task_duplicate_ignored`` carry
    their reply's ``launches``)."""
    total = dict.fromkeys(TPU_KERNEL, 0)
    for e in events:
        if e.get("event") in ("task_done", "task_duplicate_ignored"):
            for k in TPU_KERNEL:
                total[k] += (e.get("launches") or {}).get(k, 0)
    return total


def add_launches(*parts) -> dict:
    return {k: sum(p[k] for p in parts) for k in TPU_KERNEL}


def reported_runs(pairs) -> list:
    """[(worker, key)] of every task run the workers reported, from
    ``pairs`` = [(key, event)]: ``task_done`` and
    ``task_duplicate_ignored`` (a losing copy ran too), in the order of
    their events' ``ts`` (emission order where there is none).  A worker
    runs one task at a time, so this is each worker's own order."""
    done = [(k, e) for k, e in pairs if e.get("event") in
            ("task_done", "task_duplicate_ignored")]
    done.sort(key=lambda ke: ke[1].get("ts", 0.0))
    return [(e["worker"], k) for k, e in done]


def replay_run(hk, executors, pid, msg, capture, device="cuda"):
    """One task run the workers reported, made again in THIS process
    through the worker's own ``run_task`` on worker ``pid``'s replay
    executor (``executors``: worker -> executor, made at its first task
    and kept for the phase, so its slot feedback and probe caches evolve
    as that worker's did), its kernel calls into ``capture``.  Returns
    (host table, the replay's launches): the hold's, not the path's."""
    from dryad_tpu_torch.exec.data import pdata_to_host
    from dryad_tpu_torch.parallel.mesh import resolve_device
    from dryad_tpu_torch.runtime import worker
    ex = executors.get(pid)
    if ex is None:
        ex = executors[pid] = worker.task_executor(resolve_device(device),
                                                   NPARTS)
    before = dict(hk.launches)
    hk.capture = capture
    try:
        table = pdata_to_host(worker.run_task(msg, ex,
                                              ("torch_cluster_fns",)))
    finally:
        hk.capture = None
    return table, {k: hk.launches[k] - before[k] for k in TPU_KERNEL}


def hold_replayed(hk, label, held, launches, executors, runs,
                  device="cuda") -> tuple:
    """A cell's reported task runs ``runs`` = [(worker, envelope)], in
    each worker's order, replayed (``replay_run``) one at a time; each
    task's calls are captured within REPLAY_HOLD_BYTES and held against
    the plain versions before the next, and the largest errors recorded
    under ``label`` with the workers' ``launches``.  Every kernel the
    workers launched must have been replayed.  Returns (the replay's
    figures for the cell's line, with the card's free memory before it
    and this process's peak allocation during it; the host tables)."""
    import torch
    on_card = device == "cuda"
    if on_card:
        free_gib = torch.cuda.mem_get_info()[0] / 2**30
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tables, errs = [], {}
    replayed = dict.fromkeys(TPU_KERNEL, 0)
    n_held = n_unheld = 0
    for i, (pid, msg) in enumerate(runs):
        capture = BoundedCapture(REPLAY_HOLD_BYTES)
        table, got = replay_run(hk, executors, pid, msg, capture, device)
        tables.append(table)
        replayed = add_launches(replayed, got)
        for k, e in hold_run(hk, f"{label} task run {i}", capture).items():
            errs[k] = max(errs.get(k, 0.0), e)
        n_held += sum(len(c) for c in capture.values())
        n_unheld += capture.dropped
    held(label, launches, errs=errs)
    missed = [k for k in TPU_KERNEL if launches[k] and not replayed[k]]
    if missed:
        raise AssertionError(f"{label}: the replay launched no {missed}")
    line = {"replayed_tasks": len(runs), "replay_launches": replayed,
            "held_calls": n_held, "unheld_calls": n_unheld,
            "replay_s": time.perf_counter() - t0}
    if on_card:
        line.update(free_gib_before=free_gib,
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return line, tables


def farm_envelope(plan_json, task: dict) -> dict:
    return {"plan": plan_json, "sources": task, "config": None}


def sent(svc, jid) -> tuple:
    """A fleet job's (payload, config), taken just after its submission:
    a job drops its payload when it ends."""
    job = svc.job(jid)
    if job.payload is None:
        raise AssertionError(f"job {jid} ended before its payload was read")
    return job.payload, job.config


def job_runs(svc, jobs: dict) -> tuple:
    """([(worker, envelope)], [(job, task)]) of the reported task runs
    of the fleet jobs ``jobs`` (job -> ``sent``), in each worker's
    order: each envelope is the one the fleet sent."""
    pairs = []
    for j in jobs:
        pairs += [((j, e.get("task")), e) for e in svc.job(j).log.events]
    runs, keys = [], []
    for pid, (j, idx) in reported_runs(pairs):
        payload, config = jobs[j]
        runs.append((pid, {"plan": payload["plan"],
                           "sources": payload["sources"][idx],
                           "config": config}))
        keys.append((j, idx))
    return runs, keys


def farm_tables(seed: int = 18):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, FARM_KEYS, FARM_ROWS).astype(np.int32),
            "v": rng.integers(0, 100, FARM_ROWS).astype(np.int32)}


def check_farm_groupsum(label, results, cols) -> None:
    """The per-task group sums merged on the host against numpy's
    bincounts over all rows, exactly."""
    s = np.zeros(FARM_KEYS, np.int64)
    n = np.zeros(FARM_KEYS, np.int64)
    for t in results:
        k = np.asarray(t["k"], np.int64)
        np.add.at(s, k, np.asarray(t["s"], np.int64))
        np.add.at(n, k, np.asarray(t["n"], np.int64))
    want_s = np.bincount(cols["k"], weights=cols["v"].astype(np.float64),
                         minlength=FARM_KEYS).astype(np.int64)
    want_n = np.bincount(cols["k"], minlength=FARM_KEYS)
    if not (np.array_equal(s, want_s) and np.array_equal(n, want_n)):
        raise AssertionError(f"{label}: group sums differ from numpy")


def farm_plan(port, cl, cols):
    """The groupsum plan (one source leg: k, v int32 -> group_by k with
    SUM and COUNT) serialized for the cluster, and its per-task specs."""
    from dryad_tpu_torch.plan.planner import plan_query
    from dryad_tpu_torch.runtime.shiplan import serialize_for_cluster
    from dryad_tpu_torch.runtime.sources import columns_spec
    ctx = port.Context(cluster=cl)
    cap = -(-FARM_ROWS // (FARM_TASKS * NPARTS))
    ds = ctx.from_columns({"k": cols["k"][:1], "v": cols["v"][:1]},
                          capacity=cap).group_by(
        ["k"], {"s": ("sum", "v"), "n": ("count", None)})
    plan_json, specs = serialize_for_cluster(plan_query(ds.node, NPARTS))
    (src,) = specs
    bounds = np.linspace(0, FARM_ROWS, FARM_TASKS + 1).astype(np.int64)
    tasks = [{src: columns_spec({"k": cols["k"][a:b], "v": cols["v"][a:b]},
                                NPARTS, capacity=cap)}
             for a, b in zip(bounds[:-1], bounds[1:])]
    return plan_json, tasks


def farm_run(cl, plan_json, tasks, **kw):
    from dryad_tpu_torch.runtime.farm import TaskFarm
    farm = TaskFarm(cl, **kw)
    t0 = time.perf_counter()
    results = farm.run(plan_json, tasks)
    return farm, results, time.perf_counter() - t0


def farm_groupsum_8m(hk, cl, cols, plan_json, tasks, held, executors,
                     device="cuda"):
    """farm_groupsum_8m's first two runs: a plain one and one whose task
    3 is a straggler on its first copy (``delay_hook``): exactly one
    duplicate, which wins.  Each equal to numpy.  Both runs' task runs,
    the straggler's losing copy too, replayed here and held.  Returns
    the cell's line, with the workers' launches summed."""
    label = "farm_groupsum_8m"
    farm, res, plain_s = farm_run(cl, plan_json, tasks)
    check_farm_groupsum(label, res, cols)
    launches = worker_launches(farm.events)
    runs = reported_runs([(e.get("task"), e) for e in farm.events])
    slow = {"left": 1}

    def straggle(task, pid):
        if task == 3 and slow["left"]:
            slow["left"], slow["pid"] = 0, pid
            return STRAGGLER_S
        return 0.0

    cl.wait_quiescent()
    farm, res, strag_s = farm_run(cl, plan_json, tasks,
                                  delay_hook=straggle)
    check_farm_groupsum(f"{label} straggler", res, cols)
    dups = [e for e in farm.events if e["event"] == "task_duplicated"]
    won = [e for e in farm.events if e["event"] == "task_done"
           and e["task"] == 3]
    if (len(dups) != 1 or dups[0]["task"] != 3 or len(won) != 1
            or not won[0].get("dup_won")):
        raise AssertionError(f"{label}: straggler: duplicates {dups}, "
                             f"task 3 done {won}")
    launches = add_launches(launches, worker_launches(farm.events))
    # the slow first copy of task 3 runs last on its worker, after the
    # farm has returned: no event reports it
    runs += reported_runs([(e.get("task"), e) for e in farm.events])
    runs.append((slow["pid"], 3))
    replay, _tables = hold_replayed(
        hk, label, held, launches, executors,
        [(pid, farm_envelope(plan_json, tasks[t])) for pid, t in runs],
        device)
    return {"rows": FARM_ROWS, "keys": FARM_KEYS, "tasks": FARM_TASKS,
            "workers": CLUSTER_WORKERS, "nparts_per_worker": NPARTS,
            "plain_s": plain_s, "straggler_s": strag_s,
            "duplicated": dups[0], "dup_won": won[0]["worker"],
            "task_walls_s": sorted(e["wall_s"] for e in farm.events
                                   if e["event"] == "task_done"),
            "launches": launches, **replay}


def farm_kill_run(hk, cl, cols, plan_json, tasks, held, executors,
                  device="cuda") -> dict:
    """farm_groupsum_8m's last run: worker 1's tasks sleep KILL_DELAY_S
    first, and KILL_AT_S after its first dispatch the run SIGKILLs
    worker 1, speculation off: its in-flight task is reassigned and the
    result equals numpy.  Its reported task runs are replayed here and
    held as ``farm_groupsum_8m_kill`` (the killed copy, asleep, ran
    nothing)."""
    import signal
    import threading
    cl.wait_quiescent()
    victim = cl.worker_procs()[1].pid
    killer = threading.Timer(KILL_AT_S,
                             lambda: os.kill(victim, signal.SIGKILL))

    def delay(task, pid):
        if pid == 1 and killer.ident is None:     # not started yet
            killer.start()
        return KILL_DELAY_S if pid == 1 else 0.0

    try:
        farm, res, wall = farm_run(cl, plan_json, tasks,
                                   min_samples=10**6, delay_hook=delay)
    finally:
        killer.cancel()
    check_farm_groupsum("farm_groupsum_8m kill", res, cols)
    moved = [e for e in farm.events if e["event"] == "task_reassigned"]
    if not moved or cl.alive():
        raise AssertionError(f"farm_groupsum_8m kill: reassigned {moved}, "
                             f"cluster alive {cl.alive()}")
    launches = worker_launches(farm.events)
    runs = reported_runs([(e.get("task"), e) for e in farm.events])
    replay, _tables = hold_replayed(
        hk, "farm_groupsum_8m_kill", held, launches, executors,
        [(pid, farm_envelope(plan_json, tasks[t])) for pid, t in runs],
        device)
    return {"kill_s": wall, "reassigned": [e["task"] for e in moved],
            "launches": launches, "kill_replay": replay}


def svc_cluster_wordcount(hk, cl, root, seventeen, held, executors,
                          device="cuda") -> dict:
    """phase 17's wordcount jobs (SVC_WC_LINES lines, seeds 0, 1, ...)
    through ``JobService(cluster=...)``: each task's lines are packed in
    its worker (``build_source``); counts equal to phase 17's
    ``svc_wordcount`` (held there to ``collections.Counter``);
    ``fleet_s`` / ``submit_s`` beside phase 17's."""
    from dryad_tpu_torch.service import JobService
    label = "svc_cluster_wordcount"
    params = [{"n_lines": SVC_WC_LINES, "words_per_line": 6, "seed": s}
              for s in range(SVC_WC_JOBS)]
    svc = JobService(svc_config(root, "cwc"), cluster=cl, device=device)
    try:
        t0 = time.perf_counter()
        jids, payloads = [], {}
        for p, t in zip(params, list(SVC_SHARES) * SVC_WC_JOBS):
            jids.append(svc.submit("wordcount", p, tenant=t))
            payloads[jids[-1]] = sent(svc, jids[-1])
        submit_s = time.perf_counter() - t0
        fleet = [svc_done(svc, j, label)["result"] for j in jids]
        fleet_s = time.perf_counter() - t0
        events = [e for j in jids for e in svc.job(j).log.events]
        runs, _keys = job_runs(svc, payloads)
    finally:
        svc.close()
    p17 = seventeen["svc_wordcount"]
    for i, want in enumerate(p17["word_counts"]):
        if fleet[i]["words"] != want:
            raise AssertionError(f"{label} seed {i}: counts differ from "
                                 f"phase 17's")
    launches = worker_launches(events)
    replay, _tables = hold_replayed(hk, label, held, launches, executors,
                                    runs, device)
    return {"jobs": SVC_WC_JOBS, "lines": SVC_WC_LINES,
            "tasks": sum(1 for e in events if e["event"] == "task_done"),
            "fleet_s": fleet_s, "submit_s": submit_s,
            "phase17_fleet_s": p17["fleet_s"],
            "phase17_submit_s": p17["submit_s"],
            "total_words": fleet[0]["total_words"], "launches": launches,
            **replay}


def svc_cluster_sql_6m(port, hk, cl, li, orders, root, held, executors,
                       device="cuda") -> dict:
    """SQL_Q1 and SQL_Q3 over phase 14's lineitems and orders registered
    as STORES (each task's worker reads them), each submitted twice:
    the second is DTA501 (its plan and deferred specs from the pickled
    FileCache entry).  Results against numpy (phase 14's checks), and
    each job's equal to its own task runs replayed here (integers
    exactly, f32 within 16 eps |v|)."""
    from dryad_tpu_torch import sql
    from dryad_tpu_torch.analysis.canon import semantic_fingerprint
    from dryad_tpu_torch.service import JobService
    label = "svc_cluster_sql_6m"
    stores = {n: os.path.join(root, "stores", n)
              for n in ("lineitem", "orders")}
    t0 = time.perf_counter()
    ctx = port.Context(device=device, nparts=NPARTS)
    ctx.from_columns(li).to_store(stores["lineitem"])
    ctx.from_columns(orders).to_store(stores["orders"])
    del ctx
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()
    store_s = time.perf_counter() - t0
    cat = sql.Catalog()
    for n, p in stores.items():
        cat.register_store(n, p)
    checks = {SQL_Q1: lambda lb, out: check_q1agg(lb, out, li),
              SQL_Q3: lambda lb, out: check_topk_revenue(lb, out, li,
                                                          flag=0)}
    svc = JobService(svc_config(root, "csql"), cluster=cl, device=device,
                     catalog=cat)
    try:
        t0 = time.perf_counter()
        jobs, payloads = [], {}
        for q, t in ((SQL_Q1, "dash"), (SQL_Q3, "adhoc"),
                     (SQL_Q1, "batch"), (SQL_Q3, "dash")):
            jobs.append((svc.submit_sql(q, tenant=t), q))
            payloads[jobs[-1][0]] = sent(svc, jobs[-1][0])
        for jid, q in jobs:
            out = svc_table(svc_done(svc, jid, label)["result"])
            checks[q](f"{label} {jid}", out)
        all_s = time.perf_counter() - t0
        reuse = svc.log.of_type("reuse_verdict")
        if ([r["job"] for r in reuse] != [jobs[2][0], jobs[3][0]]
                or any(r["code"] != "DTA501" for r in reuse)):
            raise AssertionError(f"{label}: reuse verdicts {reuse}")
        events = [e for j, _ in jobs for e in svc.job(j).log.events]
        for q in (SQL_Q1, SQL_Q3):
            bound = sql.compile_query(cat, q)[1]
            payload, _limit, hit = svc._build_sql_farm_payload(
                bound, semantic_fingerprint(cat, bound), cat.fingerprint())
            if not hit or {s["kind"] for s in payload["sources"][0]
                           .values()} != {"store"}:
                raise AssertionError(f"{label}: the cached payload is not "
                                     f"the store specs")
        runs, keys = job_runs(svc, payloads)
        got = {j: svc_done(svc, j, label)["result"] for j, _ in jobs}
    finally:
        svc.close()
    launches = worker_launches(events)
    replay, tables = hold_replayed(hk, label, held, launches, executors,
                                   runs, device)
    from dryad_tpu_torch.service.daemon import _sql_combine
    for jid, q in jobs:
        mine = sorted((idx, t) for (j, idx), t in zip(keys, tables)
                      if j == jid)
        here = svc_table(_sql_combine(None if q == SQL_Q1 else 10)(
            [t for _idx, t in mine]))
        there = svc_table(got[jid])
        for c in here:
            a = np.asarray(there[c])
            b = np.asarray(here[c])
            if a.dtype.kind == "f":
                ok = np.allclose(a, b, rtol=16 * EPS, atol=0)
            else:
                ok = np.array_equal(a, b)
            if not ok:
                raise AssertionError(f"{label} {jid}: column {c} differs "
                                     f"from its replayed tasks'")
    shutil.rmtree(os.path.join(root, "stores"), ignore_errors=True)
    return {"jobs": len(jobs), "dta501": len(reuse), "store_s": store_s,
            "all_done_s": all_s, "launches": launches, **replay}


def forensics_replay(port, cl, root, device="cuda") -> dict:
    """A farm wordcount whose UDF raises on its one wide task: FarmError
    naming the persisted bundle, which ``python -m dryad_tpu_torch.obs
    replay <bundle> --device cuda`` reproduces in a fresh interpreter."""
    import torch_cluster_fns as fns
    from dryad_tpu_torch.apps.wordcount import wordcount_query
    from dryad_tpu_torch.plan.planner import plan_query
    from dryad_tpu_torch.runtime.farm import FarmError, TaskFarm
    from dryad_tpu_torch.runtime.shiplan import serialize_for_cluster
    from dryad_tpu_torch.runtime.sources import columns_spec
    ctx = port.Context(cluster=cl)
    q = wordcount_query(ctx.from_columns({"line": ["a"]})
                        .select(fns.poison_wide_lines),
                        tokens_per_partition=4096)
    plan_json, specs = serialize_for_cluster(plan_query(q.node, NPARTS))
    (src,) = specs
    lines = bench_corpus(4000)
    tasks = [{src: columns_spec({"line": lines[i::4]}, NPARTS,
                                str_max_len=128 if i == 3 else 64)}
             for i in range(4)]
    bundles = os.path.join(root, "bundles")
    port_cfg = port.JobConfig(forensics_dir=bundles)
    try:
        TaskFarm(cl, min_samples=10**9, config=port_cfg).run(plan_json,
                                                             tasks)
    except FarmError as e:
        msg = str(e)
    else:
        raise AssertionError("forensics_replay: the poison task passed")
    (name,) = os.listdir(bundles)
    bpath = os.path.join(bundles, name)
    if f"forensics bundle: {bpath}" not in msg:
        raise AssertionError(f"forensics_replay: {msg[-500:]}")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "dryad_tpu_torch.obs", "replay", bpath,
         "--device", device], cwd=HERE, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=TESTS + os.pathsep
                              + HERE))
    if res.returncode != 0 or "verdict  : REPRODUCED" not in res.stdout:
        raise AssertionError(f"forensics_replay: replay rc "
                             f"{res.returncode}:\n{res.stdout[-2000:]}"
                             f"\n{res.stderr[-2000:]}")
    return {"bundle": name, "replay_s": time.perf_counter() - t0,
            "verdict": "REPRODUCED"}


def chaos_seed3(root, device="cuda") -> dict:
    """``run_scenario(seed=3)`` on the card: the victim daemon process
    SIGKILLed past its target job's first settled stage, the successor
    (in this process) adopting the journal."""
    from dryad_tpu_torch.chaos import run_scenario
    t0 = time.perf_counter()
    rep = run_scenario(seed=3, workdir=os.path.join(root, "chaos"),
                       timeout=SVC_WAIT_S, device=device)
    if not (rep["ok"] and rep["spills_at_kill"] >= 1
            and rep["stages_restored"] >= 1 and rep["standing_recovered"]
            and rep["recovery"]["resumed"] >= 1
            and rep["recovery"]["readmitted"] >= 1):
        raise AssertionError("chaos_seed3: " + json.dumps(rep, default=str)
                             [-3000:])
    inv = rep["invariants"]
    return {"ok": True, "seconds": time.perf_counter() - t0,
            "spills_at_kill": rep["spills_at_kill"],
            "stages_restored": rep["stages_restored"],
            "recovery": rep["recovery"], "lost": inv["lost"],
            "dup_terminals": inv["dup_terminals"],
            "diverged": inv["diverged"], "torn": rep["torn_injected"]}


def phase18_runs(port, hk, tables, root: str, held, seventeen,
                 device="cuda") -> dict:
    """Phase 18's cells over phase 14's ``sql_catalog`` triple
    ``tables``: one ``LocalCluster(CLUSTER_WORKERS, NPARTS)`` on the
    card serves farm_groupsum_8m (its kill run last), the cluster
    service's wordcount and SQL cells and forensics_replay; then
    chaos_seed3.  The farm and service cells' launches are the workers'
    (``task_done``), their calls held on every reported task run
    replayed here, each worker's through an executor of its own kept
    for the phase (``hold_replayed``; forensics_replay's runs are not
    replayed); chaos_seed3's are its successor's, in this process."""
    from dryad_tpu_torch.runtime import LocalCluster
    li, orders, _cat = tables
    if TESTS not in sys.path:
        sys.path.insert(0, TESTS)
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = TESTS + (os.pathsep + old if old else "")
    lines = {}
    t0 = time.perf_counter()
    cl = LocalCluster(n_processes=CLUSTER_WORKERS,
                      devices_per_process=NPARTS,
                      fn_modules=("torch_cluster_fns",), device=device,
                      log_dir=os.path.join(root, "workers"))
    try:
        start_s = time.perf_counter() - t0
        executors = {}      # worker -> its replay executor
        cols = farm_tables()
        plan_json, tasks = farm_plan(port, cl, cols)
        line = farm_groupsum_8m(hk, cl, cols, plan_json, tasks, held,
                                executors, device)
        line["cluster_start_s"] = start_s
        lines["svc_cluster_wordcount"] = svc_cluster_wordcount(
            hk, cl, root, seventeen, held, executors, device)
        lines["svc_cluster_sql_6m"] = svc_cluster_sql_6m(
            port, hk, cl, li, orders, root, held, executors, device)
        lines["forensics_replay"] = forensics_replay(port, cl, root,
                                                     device)
        kill = farm_kill_run(hk, cl, cols, plan_json, tasks, held,
                             executors, device)
        line.update(kill_s=kill["kill_s"], reassigned=kill["reassigned"],
                    kill_replay=kill["kill_replay"])
        line["launches"] = add_launches(line["launches"], kill["launches"])
        lines["farm_groupsum_8m"] = line
        del executors
        if device == "cuda":
            import torch
            torch.cuda.empty_cache()
    finally:
        cl.shutdown()
        if old is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old
    lines["chaos_seed3"] = svc_cell(hk, "chaos_seed3", held,
                                    lambda: chaos_seed3(root, device))
    return lines


# ---------------------------------------------------------------------------
# phase 19: the gang (SPMD jobs across worker processes)

GANG_PROCS, GANG_DPP = 2, NPARTS // 2     # P = 8, as in phases 3-7
GANG_BARRIER_S = 600.0     # a replay thread waits this long at a collective
GANG_WATCHDOG = dict(gang_heartbeat_s=0.5, gang_heartbeat_timeout_s=4.0,
                     gang_straggler_rel_margin=0.0,
                     gang_straggler_abs_margin_s=2.0)
GANG_SLOW = "1:3"          # worker 1's replies 3 s late, its beats flowing
GANG_STEP_BYTES = 64 << 10  # a superstep's control message, at most
STAGED_KEYS = ("collectives", "host_syncs", "bytes", "wait_s", "d2h_s",
               "gloo_s", "h2d_s")


class _Rendezvous:
    """The collectives of replay threads in one process: each rank puts
    its tensor in its slot, and every rank reads all of them."""

    def __init__(self, world: int):
        import threading
        self.slots = [None] * world
        self.barrier = threading.Barrier(world, timeout=GANG_BARRIER_S)

    def gather(self, rank: int, x):
        self.slots[rank] = x
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got


def thread_mesh(port_mesh, device, rank: int, world: int, rdv):
    """A gang ``parallel.mesh.Mesh`` whose collectives meet other threads
    of this process (``_Rendezvous``) instead of gloo: a gang job replayed
    here launches every kernel at the workers' shapes, on tensors this
    process can hold against the plain versions."""
    import torch

    @dataclasses.dataclass(frozen=True)
    class ThreadMesh(port_mesh.Mesh):
        def all_to_all(self, x):
            return torch.stack([g[rank] for g in rdv.gather(rank, x)])

        def all_gather(self, x):
            return torch.stack(rdv.gather(rank, x))

        def all_reduce_max(self, x):
            return torch.stack(rdv.gather(rank, x)).amax(0)

        def from_next(self, x):
            got = rdv.gather(rank, x)
            return (got[rank + 1].clone() if rank + 1 < world
                    else torch.zeros_like(x))

    return ThreadMesh(device, NPARTS, rank, world)


def replay_gang(port, hk, apps, device="cuda") -> dict:
    """Each ``app(ctx)`` of ``apps`` run as a gang of GANG_PROCS threads
    of this process (``thread_mesh``), every kernel call captured; the
    calls are held after the runs.  Returns (captured, launches)."""
    import threading

    import torch
    from dryad_tpu_torch.parallel import mesh as port_mesh
    dev = torch.device(device)
    before = dict(hk.launches)
    hk.capture = {}
    errors = []
    for app in apps:
        rdv = _Rendezvous(GANG_PROCS)

        def rank_run(r, app=app, rdv=rdv):
            try:
                # a worker's context: the gang mesh's levels, its executor
                app(port.Context(mesh=thread_mesh(port_mesh, dev, r,
                                                  GANG_PROCS, rdv)))
            except BaseException as e:      # surfaced after the join
                errors.append(e)
                rdv.barrier.abort()
        threads = [threading.Thread(target=rank_run, args=(r,))
                   for r in range(GANG_PROCS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            hk.capture = None
            raise errors[0]
    captured, hk.capture = hk.capture, None
    return captured, {k: hk.launches[k] - before[k] for k in TPU_KERNEL}


class GangJobs:
    """Wraps a cluster's ``execute``: every gang job's reply is kept, and
    the control messages' pickled sizes (per job, worker 0's copy)."""

    def __init__(self, cl):
        import pickle

        from dryad_tpu_torch.runtime import cluster as cluster_mod
        self.replies, self.sent = [], []
        real, send = cl.execute, cluster_mod.protocol.send_msg

        def execute(*a, **kw):
            r = real(*a, **kw)
            self.replies.append(r)
            return r

        def counting_send(sock, obj):
            if (isinstance(obj, dict) and obj.get("cmd") == "run"
                    and sock is cl.sockets.get(0)):
                self.sent.append(len(pickle.dumps(obj, protocol=4)))
            return send(sock, obj)
        cl.execute = execute
        self._undo = lambda: (setattr(cluster_mod.protocol, "send_msg",
                                      send), cl.__dict__.pop("execute"))
        cluster_mod.protocol.send_msg = counting_send

    def take(self) -> tuple:
        r, s = self.replies, self.sent
        self.replies, self.sent = [], []
        return r, s

    def close(self) -> None:
        self._undo()


def gang_figures(label, replies, device="cuda") -> dict:
    """One cell run's figures from its jobs' replies: each worker's
    launches, the staged collectives per worker, the exchanges (from
    worker 0's stage logs, held to its launches by
    ``check_per_exchange``; on the CPU the workers' plain versions count
    nothing, so a rehearsal checks the logs only) and the host syncs per
    exchange.  Both workers' stage logs must be equal (the mirrored
    decisions)."""
    workers = sorted(replies[0]["workers"])
    launches = {w: dict.fromkeys(TPU_KERNEL, 0) for w in workers}
    staged = {w: dict.fromkeys(STAGED_KEYS, 0) for w in workers}
    logs = {w: [] for w in workers}
    for r in replies:
        for w, info in r["workers"].items():
            for k in TPU_KERNEL:
                launches[w][k] += info["launches"].get(k, 0)
            for k in STAGED_KEYS:
                staged[w][k] += info["staged"].get(k, 0)
            logs[w].append(info["stage_log"])
    keep = ("label", "attempts", "scale", "slack", "salted",
            "salted_attempts", "slot_rows", "slot_source", "recv_rows")
    same = [[{k: e[k] for k in keep} for log in logs[w] for e in log]
            for w in workers]
    if any(s != same[0] for s in same):
        raise AssertionError(f"{label}: the workers' stage logs differ")
    stages = exchanging_stages(logs[0])
    for w in (workers if device == "cuda" else ()):
        check_per_exchange(f"{label} worker {w}", launches[w],
                           exchange_attempts(stages),
                           broadcast_attempts(stages), probes_run(stages))
    n_ex = exchange_attempts(stages) + broadcast_attempts(stages)
    return {"jobs": len(replies), "worker_launches": launches,
            "staged": staged, "exchanges": n_ex,
            "host_syncs_per_exchange": staged[0]["host_syncs"] / max(n_ex, 1),
            "stages": stages}


def gang_cell(label, gj, gang_app, local_app, check,
              device="cuda") -> dict:
    """A phase-19 cell: ``gang_app`` on the gang (one cold run: the warm
    rerun was cut for the script's time, PR 20), and ``local_app`` in
    process beside it; ``check(gang, local)`` holds the results.
    Returns its line with the run's figures (``gang_figures``) and its
    replies under ``"_replies"``."""
    import torch
    gj.take()
    t0 = time.perf_counter()
    out = gang_app()
    cold_s = time.perf_counter() - t0
    replies, sent = gj.take()
    t0 = time.perf_counter()
    local = local_app()
    if device == "cuda":
        torch.cuda.synchronize()
    local_s = time.perf_counter() - t0
    sizes = check(out, local)
    fig = gang_figures(label, replies, device)
    return {**sizes, "nparts": NPARTS, "processes": GANG_PROCS,
            "cold_wall_s": cold_s, "inprocess_wall_s": local_s, **fig,
            "sent_bytes": sent, "_replies": replies}


def _tables_equal(label, a, b) -> None:
    if set(a) != set(b):
        raise AssertionError(f"{label}: columns {sorted(a)} != {sorted(b)}")
    for k in a:
        same = (list(a[k]) == list(b[k]) if isinstance(a[k], list)
                else np.array_equal(np.asarray(a[k]), np.asarray(b[k])))
        if not same:
            raise AssertionError(f"{label}: column {k} differs from the "
                                 f"in-process run's")


def gang_pagerank(ctx, F, edges, n_nodes: int, n_iters: int):
    """``apps/pagerank.pagerank`` with its two selects as the shippable
    ``torch_cluster_fns.pr_contrib`` / ``pr_damp`` (the app's lambdas
    close over the damping and the node count, and a closure does not
    ship): the same stages, the same arithmetic."""
    edges_ds = ctx.from_columns(edges)
    deg = edges_ds.group_by(["src"], {"deg": ("count", None)})
    edges_deg = edges_ds.join(deg, ["src"], ["src"], expansion=2.0,
                              right_unique=True).cache()
    ranks0 = ctx.from_columns(
        {"node": np.arange(n_nodes, dtype=np.int32),
         "rank": np.full(n_nodes, 1.0 / n_nodes, np.float32)})
    rank_cap = min(n_nodes, 4 * (-(-n_nodes // ctx.nparts)) + 8)

    def body(ranks):
        return (edges_deg.join(ranks, ["src"], ["node"], expansion=2.0,
                               right_unique=True)
                .select(F.pr_contrib).group_by(["node"], {"s": ("sum", "c")})
                .select(F.pr_damp).with_capacity(rank_cap))
    return ctx.do_while(ranks0.with_capacity(rank_cap), body,
                        n_iters=n_iters).collect()


def gang_skew_join(ctx, F, li, orders):
    """skewjoin6m's join (phase 9's ``skew_join_groups`` by custkey) with
    shippable UDFs, collected."""
    return (ctx.from_columns(li).join(ctx.from_columns(orders), ["okey"])
            .where(F.flag0).select(F.rev_by_custkey)
            .group_by(["custkey"], {"revenue": ("sum", "rev"),
                                    "n": ("count", None)})).collect()


def gang_watchdog(port, cl, events) -> dict:
    """Both watchdog holds on the card.  A frozen member (SIGSTOP: its
    heartbeats stop) is declared wedged within the heartbeat timeout and
    the job replays on a fresh gang; that gang's worker 1 replies
    GANG_SLOW late with its heartbeats flowing (``DRYAD_TEST_REPLY_DELAY``
    in the workers' environment), past the 2 s straggler margin, and
    must not be declared wedged: the replayed job returns the right
    count with exactly one wedge, the frozen worker's."""
    import signal
    cfg = port.JobConfig(cluster_job_timeout_s=600.0, **GANG_WATCHDOG)
    ctx = port.Context(cluster=cl, config=cfg, event_log=events.append)
    v = np.arange(40_000, dtype=np.int32)
    ds = ctx.from_columns({"v": v}).group_by(["v"], {"n": ("count", None)})
    if ds.count() != len(v):
        raise AssertionError("gang watchdog: the warm-up count is wrong")
    n0 = len(events)
    frozen = cl._procs[1].pid
    os.environ["DRYAD_TEST_REPLY_DELAY"] = GANG_SLOW
    os.kill(frozen, signal.SIGSTOP)
    t0 = time.perf_counter()
    try:
        got = ds.count()
    finally:
        os.environ.pop("DRYAD_TEST_REPLY_DELAY", None)
        try:
            os.kill(frozen, signal.SIGCONT)
        except OSError:
            pass
    wall = time.perf_counter() - t0
    wedges = [e for e in events[n0:] if e.get("event") == "worker_wedged"]
    if got != len(v) or len(wedges) != 1 or wedges[0]["workers"] != [1]:
        raise AssertionError(f"gang watchdog: count {got}, wedges "
                             f"{[(e['workers'], e['why']) for e in wedges]}")
    if wall > 120:
        raise AssertionError(f"gang watchdog: the replay took {wall:.1f} s")
    return {"frozen_wedged": wedges[0]["why"], "replay_wall_s": wall,
            "slow_reply_delay": GANG_SLOW, "slow_wedged": False,
            "config": GANG_WATCHDOG}


def phase19_runs(port, hk, wc, ts, corpus, wc_counts, tera, edges,
                 n_nodes: int, pr, lineitems: int, root: str, held,
                 device="cuda", keep=None) -> dict:
    """Phase 19's cells on one ``LocalCluster(GANG_PROCS, GANG_DPP)`` on
    the card (P = 8; see the module docstring), each against the same
    query in this process; the workers' calls held on a replay of
    terasort1m and two PageRank supersteps here as a gang of threads
    (``replay_gang``), at the workers' shapes.  ``keep`` (a dict) gets
    gang_zipf50k's table under ``"zipf_out"``."""
    import contextlib

    import torch
    from dryad_tpu_torch.exec.executor import Executor
    from dryad_tpu_torch.runtime import LocalCluster
    if TESTS not in sys.path:
        sys.path.insert(0, TESTS)
    import torch_cluster_fns as F
    # every range stage's split points, by the mesh's world: the
    # in-process run's (1) and the replay's ranks' (GANG_PROCS)
    bounds = collections.defaultdict(list)

    @contextlib.contextmanager
    def recording_bounds():
        real = Executor._range_bounds

        def recorded(self, src, key):
            b = real(self, src, key)
            bounds[self.mesh.world].append(b.tolist())
            return b
        Executor._range_bounds = recorded
        try:
            yield
        finally:
            Executor._range_bounds = real
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = TESTS + (os.pathsep + old if old else "")
    os.environ["DRYAD_GANG_PR_NODES"] = str(n_nodes)
    F.PR_NODES = n_nodes
    lines, events = {}, []
    t0 = time.perf_counter()
    cl = LocalCluster(n_processes=GANG_PROCS, devices_per_process=GANG_DPP,
                      fn_modules=("torch_cluster_fns",), device=device,
                      log_dir=os.path.join(root, "workers"))
    start_s = time.perf_counter() - t0
    gj = GangJobs(cl)
    try:
        gctx = port.Context(cluster=cl, event_log=events.append)
        # the gang plans the levels of its (dcn, dp) mesh, so its
        # in-process counterpart runs on that mesh
        lctx = port.Context(mesh=port.make_mesh(device, NPARTS,
                                                hosts=GANG_PROCS))
        per_part = -(-len(corpus) // NPARTS)
        # the corpus as a text file each worker reads (no 60 MB column
        # pickled over the control socket)
        text = os.path.join(root, "zipf50k.txt")
        with open(text, "w") as f:
            f.write("\n".join(corpus) + "\n")

        def wordcount(ctx):
            return wc.wordcount_query(
                ctx.read_text(text, max_line_len=96),
                tokens_per_partition=per_part * 10).collect()

        def wc_check(out, local):
            _tables_equal("gang_zipf50k", out, local)
            if keep is not None:
                keep["zipf_out"] = out
            if dict(zip(out["line"], (int(v) for v in out["n"]))) != \
                    wc_counts:
                raise AssertionError("gang_zipf50k: counts differ from "
                                     "phase 3's (the Counter oracle's)")
            return {"lines": len(corpus), "words": len(out["line"])}
        line = gang_cell("gang_zipf50k", gj, lambda: wordcount(gctx),
                         lambda: wordcount(lctx), wc_check, device)
        line["cluster_start_s"] = start_s
        lines["gang_zipf50k"] = line

        data, sml = tera

        def terasort(ctx):
            return ts.terasort_query(ctx.from_columns(
                data, str_max_len=sml)).collect()

        def tera_local():
            # the in-process run's range bounds, kept for the replay's
            with recording_bounds():
                return terasort(lctx), list(lctx.executor.stage_log)

        def tera_check(out, local):
            _tables_equal("gang_terasort1m", out, local[0])
            tera_local_run[:] = local
            return {"records": len(out["key"])}
        tera_local_run = []
        line = gang_cell("gang_terasort1m", gj, lambda: terasort(gctx),
                         tera_local, tera_check, device)
        # the range exchange's received rows per partition: the same
        # split points, so the same partitions
        grecv = [e["recv_rows"] for e in line["_replies"][0]["stage_log"]
                 if e["exchange"] == "range"]
        tera_out, tlog = tera_local_run
        lrecv = [e["recv_rows"] for e in tlog if e["exchange"] == "range"]
        if not grecv or grecv != lrecv:
            raise AssertionError(f"gang_terasort1m: range-exchanged rows "
                                 f"{grecv} against the in-process {lrecv}")
        line["range_recv_rows"] = grecv
        lines["gang_terasort1m"] = line

        def pagerank(ctx, iters=PR_ITERS):
            return gang_pagerank(ctx, F, edges, n_nodes, iters)

        def pr_check(out, local):
            if not np.array_equal(out["node"], local["node"]):
                raise AssertionError("gang_pagerank100k: nodes differ from "
                                     "the in-process run's")
            a, b = (np.asarray(t["rank"], np.float64) for t in (out, local))
            rel = float((np.abs(a - b) / np.abs(b)).max())
            if not rel <= 1e-6:
                raise AssertionError(f"gang_pagerank100k: a rank is {rel} "
                                     f"off the in-process run's")
            return {**check_pagerank(out, edges, n_nodes, pr),
                    "max_rel_diff_inprocess": rel,
                    "bit_equal_inprocess": a.tobytes() == b.tobytes()}
        line = gang_cell("gang_pagerank100k", gj, lambda: pagerank(gctx),
                         lambda: pagerank(lctx), pr_check, device)
        steps = line["sent_bytes"][2:-1]   # edges, ranks; the collect
        if not steps or max(steps) > GANG_STEP_BYTES or \
                line["sent_bytes"][0] < len(edges["src"]) * 8:
            raise AssertionError(f"gang_pagerank100k: control messages "
                                 f"{line['sent_bytes']} bytes")
        line["superstep_message_bytes_max"] = max(steps)
        lines["gang_pagerank100k"] = line

        li, orders, _ = tpch_tables(lineitems)

        def sj_local():
            ex = lctx.executor
            out = gang_skew_join(lctx, F, li, orders)
            return out, list(ex.stage_log)
        local_log = []

        def sj_check(out, local):
            lout, llog = local
            local_log[:] = llog
            _tables_equal("gang_skewjoin6m", out, lout)
            return {"lineitems": lineitems, "groups": len(out["custkey"])}
        line = gang_cell("gang_skewjoin6m", gj,
                         lambda: gang_skew_join(gctx, F, li, orders),
                         sj_local, sj_check, device)
        keep = ("attempts", "scale", "slack", "salted", "salted_attempts",
                "slot_rows", "slot_source", "recv_rows")
        (gjoin,) = [e for e in line["_replies"][0]["stage_log"]
                    if e["label"] == "join"]
        (ljoin,) = [e for e in local_log if e["label"] == "join"]
        if not (gjoin["attempts"] == 2 and gjoin["salted"]
                and gjoin["salted_attempts"] == 1) or \
                {k: gjoin[k] for k in keep} != {k: ljoin[k] for k in keep}:
            raise AssertionError(f"gang_skewjoin6m: join stage {gjoin} "
                                 f"against the in-process {ljoin}")
        line["join_stage"] = {k: gjoin[k] for k in keep
                              if k != "recv_rows"}
        lines["gang_skewjoin6m"] = line
        del li, orders

        # terasort1m's output by parallel gzip to_store, read back; then a
        # cache() healed after a gang restart
        store = os.path.join(root, "tera_gz")
        t1 = time.perf_counter()
        ts.terasort_query(gctx.from_columns(data, str_max_len=sml)) \
            .to_store(store, compression="gzip")
        store_s = time.perf_counter() - t1
        back = gctx.from_store(store).collect()
        _tables_equal("gang_store_cache read-back", back, tera_out)
        cached = gctx.from_store(store).cache()
        n_before = cached.count()
        n0 = len(events)
        cl.restart()
        t1 = time.perf_counter()
        healed = cached.collect()
        heal_s = time.perf_counter() - t1
        _tables_equal("gang_store_cache healed", healed, tera_out)
        missing = [e for e in events[n0:] if e.get("event") == "job_failed"
                   and "MissingResidentToken" in e.get("error", "")]
        if n_before != len(tera_out["key"]) or not missing:
            raise AssertionError("gang_store_cache: the cache() did not "
                                 "heal through MissingResidentToken")
        lines["gang_store_cache"] = {
            "records": n_before, "store_s": store_s, "heal_s": heal_s,
            "compression": "gzip", "healed_through": "MissingResidentToken"}
        gj.take()
        lines["gang_watchdog"] = gang_watchdog(port, cl, events)
    finally:
        gj.close()
        cl.shutdown()
        os.environ.pop("DRYAD_GANG_PR_NODES", None)
        if old is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old

    # the workers' kernel calls at their shapes: terasort1m and two
    # PageRank supersteps replayed here as a gang of threads, every call
    # held against the plain versions; the range bounds (the gang's code
    # on the gang's partitions) bit-equal to the in-process run's
    torch.cuda.empty_cache()
    with recording_bounds():
        captured, replayed = replay_gang(port, hk, [
            terasort, lambda c: pagerank(c, 2)], device)
    # (a settle's replay of the sort stage samples its input again)
    if len(bounds[GANG_PROCS]) < GANG_PROCS or len(
            {tuple(b) for b in bounds[1] + bounds[GANG_PROCS]}) != 1:
        raise AssertionError("gang_terasort1m: the gang's range bounds "
                             "differ from the in-process run's")
    lines["gang_terasort1m"]["bounds_bit_equal_inprocess"] = True
    errs = hold_run(hk, "gang replay", captured)
    shapes = {k: [tuple(a.shape) for a in calls[0][1]
                  if hasattr(a, "shape")] for k, calls in captured.items()}
    del captured
    total = dict.fromkeys(TPU_KERNEL, 0)
    for label in ("gang_zipf50k", "gang_terasort1m", "gang_pagerank100k",
                  "gang_skewjoin6m"):
        line = lines[label]
        line.pop("_replies")
        for w in line["worker_launches"].values():
            total = add_launches(total, w)
    missed = [k for k in TPU_KERNEL if not total[k] or not replayed[k]]
    if missed and device == "cuda":
        raise AssertionError(f"phase 19: {missed} not launched by the "
                             f"workers or not replayed")
    held("gang", total, errs=errs)
    lines["gang_replay"] = {"replay_launches": replayed,
                            "max_abs_err": errs, "first_call_shapes": shapes,
                            "worker_launches": total}
    return lines


# ---------------------------------------------------------------------------
# phase 20: the streamed gang and the SSH backend

STREAM_TAKE = 1_000    # gang_stream_terasort10m's take(n) after the sort


def stream_gang_figures(label, replies, device="cuda") -> dict:
    """A streamed gang cell run's figures from its jobs' replies: each
    worker's launches, staged collectives and streamed-plan counters
    (the reply's ``stream``: waves, capacity retries, exchange attempts
    by kind, bytes spilled to bucket stores, compactions, range bounds).
    The mirrored counters and the bounds must be equal in both workers;
    on the card each worker's ``slot_expand`` must equal its hash and
    range exchange attempts and ``slot_compact`` those plus its
    broadcasts (a streamed job's only exchange kernels)."""
    workers = sorted(replies[0]["workers"])
    launches = {w: dict.fromkeys(TPU_KERNEL, 0) for w in workers}
    staged = {w: dict.fromkeys(STAGED_KEYS, 0) for w in workers}
    stream = {w: {"waves": 0, "retries": 0, "compacted_legs": 0,
                  "compactions": 0, "spilled_bytes": 0,
                  "attempts": collections.Counter(), "bounds": []}
              for w in workers}
    compile_s = dict.fromkeys(workers, 0.0)
    for r in replies:
        for w, info in r["workers"].items():
            for k in TPU_KERNEL:
                launches[w][k] += info["launches"].get(k, 0)
            for k in STAGED_KEYS:
                staged[w][k] += info["staged"].get(k, 0)
            st = info.get("stream") or {}
            for k in ("waves", "retries", "compacted_legs", "compactions",
                      "spilled_bytes"):
                stream[w][k] += st.get(k, 0)
            stream[w]["attempts"].update(st.get("attempts", {}))
            stream[w]["bounds"].extend(st.get("bounds", []))
            compile_s[w] = max(compile_s[w], info.get("compile_s") or 0.0)
    s0 = stream[workers[0]]
    for w in workers:
        if any(stream[w][k] != s0[k] for k in
               ("waves", "retries", "attempts", "compacted_legs",
                "bounds")):
            raise AssertionError(f"{label}: the workers' waves, retries or "
                                 f"range bounds differ: {stream}")
    att = s0["attempts"]
    for w in (workers if device == "cuda" else ()):
        ln = launches[w]
        if (ln["slot_expand"] != att["hash"] + att["range"]
                or ln["slot_compact"] != att["hash"] + att["range"]
                + att["broadcast"]):
            raise AssertionError(f"{label} worker {w}: launches {ln} for "
                                 f"exchange attempts {dict(att)}")
    return {"jobs": len(replies), "worker_launches": launches,
            "staged": staged, "waves": s0["waves"],
            "retries": s0["retries"], "exchange_attempts": dict(att),
            "spilled_bytes": {w: stream[w]["spilled_bytes"]
                              for w in workers},
            "compacted_legs": s0["compacted_legs"],
            "compactions": {w: stream[w]["compactions"] for w in workers},
            "bounds": s0["bounds"], "compile_s": compile_s}


def stream_gang_cell(label, gj, cold_app, warm_app, check, local_wall,
                     device="cuda") -> dict:
    """A phase-20 cell: ``cold_app`` on the gang, then ``warm_app`` (the
    same query; the TeraSort's writes to hdfs://; None: no warm run),
    each checked by ``check(out)``; the in-process streamed run's warm
    wall (phase 13's) beside them.  Returns its line with both runs'
    figures and their replies under ``"_replies"``."""
    gj.take()
    t0 = time.perf_counter()
    out = cold_app()
    cold_s = time.perf_counter() - t0
    replies, sent = gj.take()
    sizes = check(out)
    fig = stream_gang_figures(label, replies, device)
    line = {**sizes, "nparts": NPARTS, "processes": GANG_PROCS,
            "cold_wall_s": cold_s, "inprocess_warm_wall_s": local_wall,
            **fig, "sent_bytes": sent, "_replies": replies}
    if warm_app is not None:
        t0 = time.perf_counter()
        wout = warm_app()
        line["warm_wall_s"] = time.perf_counter() - t0
        wreplies, _ = gj.take()
        check(wout)
        wfig = stream_gang_figures(label + " warm", wreplies, device)
        line["warm"] = {k: wfig[k] for k in (
            "staged", "waves", "retries", "exchange_attempts",
            "spilled_bytes", "compactions", "worker_launches")}
        line["_replies"] = replies + wreplies
    return line


def numpy_gang_cut(ooc, path: str, chunk: int, key: str,
                   per_chunk: int = 512, cap: int = 8192):
    """The range bounds a gang of GANG_PROCS x GANG_DPP must cut over the
    string key ``key`` of ``path``, in plain numpy: each store partition
    read whole (``ChunkSource.from_store`` with one chunk a partition, the
    reader only) and sliced into ``chunk``-row chunks, ``min(rows,
    per_chunk)`` evenly spaced rows a chunk, each key's first four bytes
    big-endian (bytes past its length as 0), at most ``cap`` evenly spaced
    samples a local partition and a rank (partition g of rank r streams
    the store partitions p with p mod P = g), the ranks in order, sorted,
    and the ``len * (i + 1) // P``-th as bound i."""
    from dryad_tpu_torch.io.store import store_meta

    def capped(s):
        if len(s) > cap:
            s = s[np.linspace(0, len(s) - 1, cap).astype(np.int64)]
        return s

    nparts = store_meta(path)["npartitions"]
    ranks = []
    for r in range(GANG_PROCS):
        rank = []
        for d in range(GANG_DPP):
            parts = [p for p in range(nparts)
                     if p % NPARTS == r * GANG_DPP + d]
            s = []
            for whole in ooc.ChunkSource.from_store(path, 1 << 40,
                                                    partitions=parts):
                data, lens = whole.cols[key]
                for a in range(0, whole.n, chunk):
                    n = min(chunk, whole.n - a)
                    idx = a + np.linspace(0, n - 1, min(n, per_chunk)
                                          ).astype(np.int64)
                    b = np.where(np.arange(4)[None, :] < lens[idx][:, None],
                                 data[idx, :4], 0).astype(np.uint32)
                    s.append((b[:, 0] << 24) | (b[:, 1] << 16)
                             | (b[:, 2] << 8) | b[:, 3])
            rank.append(capped(np.concatenate(s) if s
                               else np.zeros((0,), np.uint32)))
        ranks.append(capped(np.concatenate(rank)))
    s = np.sort(np.concatenate(ranks))
    return np.asarray([s[min(len(s) * (i + 1) // NPARTS, len(s) - 1)]
                       for i in range(NPARTS - 1)], np.uint32)


def replay_stream_gang(port, hk, plans, device="cuda"):
    """Each ``(plan_json, specs)`` of ``plans`` run as a streamed gang job
    (``runtime/stream_plan.execute_stream_plan``, the count terminal) by
    GANG_PROCS threads of this process (``thread_mesh``), every kernel
    call captured.  Returns (captured, launches, each rank's ``stream``
    counters)."""
    import threading

    import torch
    from dryad_tpu_torch.parallel import mesh as port_mesh
    from dryad_tpu_torch.runtime.shiplan import resolve_fn_table
    from dryad_tpu_torch.runtime.stream_plan import execute_stream_plan
    dev = torch.device(device)
    before = dict(hk.launches)
    hk.capture = {}
    errors, stats = [], []
    for plan_json, specs in plans:
        rdv = _Rendezvous(GANG_PROCS)
        fns = resolve_fn_table(plan_json, ("torch_cluster_fns",))

        def rank_run(r, plan_json=plan_json, specs=specs, fns=fns, rdv=rdv):
            try:
                mesh = thread_mesh(port_mesh, dev, r, GANG_PROCS, rdv)
                _n, extras = execute_stream_plan(plan_json, fns, specs, mesh,
                                                 collect="count")
                stats.append(extras["stream"])
            except BaseException as e:      # surfaced after the join
                errors.append(e)
                rdv.barrier.abort()
        threads = [threading.Thread(target=rank_run, args=(r,))
                   for r in range(GANG_PROCS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            hk.capture = None
            raise errors[0]
    captured, hk.capture = hk.capture, None
    return (captured, {k: hk.launches[k] - before[k] for k in TPU_KERNEL},
            stats)


def cache_stores(root: str) -> dict:
    """A cache root's entries' data stores, by their sorted column
    names."""
    from dryad_tpu_torch.io.store import store_meta
    out = {}
    for name in sorted(os.listdir(root)):
        data = os.path.join(root, name, "data")
        if os.path.isdir(data):
            out[tuple(sorted(store_meta(data)["schema"]))] = data
    return out


def ssh_gang_cell(port, wc, corpus, wc_counts, zipf19, root,
                  device="cuda") -> dict:
    """ssh_gang_zipf50k: an ``SshCluster`` of two hosts over the ``bash
    -c`` transport (the code staged into a fresh root, its kernels built
    there from the staged sources at the workers' start) runs phase 3's
    zipf WordCount: counts against the ``Counter`` oracle's and the table
    against phase 19's gang run.  Then worker 1's transport
    process is killed, and the next job runs on a fresh gang."""
    from dryad_tpu_torch.runtime import SshCluster
    text = os.path.join(root, "zipf50k.txt")
    with open(text, "w") as f:
        f.write("\n".join(corpus) + "\n")
    per_part = -(-len(corpus) // NPARTS)
    t0 = time.perf_counter()
    cl = SshCluster(hosts=["nodeA", "nodeB"], devices_per_process=GANG_DPP,
                    driver_host="127.0.0.1", coordinator_host="127.0.0.1",
                    python=sys.executable,
                    remote_root=os.path.join(root, "ssh-root"),
                    device=device, remote_pythonpath=[TESTS],
                    fn_modules=("torch_cluster_fns",),
                    rsh=lambda host, cmd: ["bash", "-c", cmd],
                    log_dir=os.path.join(root, "ssh-workers"))
    start_s = time.perf_counter() - t0
    sj = GangJobs(cl)
    try:
        ctx = port.Context(cluster=cl)

        def wordcount():
            return wc.wordcount_query(ctx.read_text(text, max_line_len=96),
                                      tokens_per_partition=per_part * 10
                                      ).collect()

        def check(out):
            if dict(zip(out["line"], (int(v) for v in out["n"]))) != \
                    wc_counts:
                raise AssertionError("ssh_gang_zipf50k: counts differ from "
                                     "phase 3's (the Counter oracle's)")
            _tables_equal("ssh_gang_zipf50k", out, zipf19)
        # one run: its warm rerun was cut for the script's time
        t0 = time.perf_counter()
        check(wordcount())
        cold_s = time.perf_counter() - t0
        replies, _ = sj.take()
        fig = gang_figures("ssh_gang_zipf50k", replies[:1], device)
        build_s = max(info.get("compile_s") or 0.0
                      for info in replies[0]["workers"].values())
        cl._procs[1].kill()
        cl._procs[1].wait()
        t0 = time.perf_counter()
        check(wordcount())
        restart_s = time.perf_counter() - t0
        sj.take()
        if not cl.alive():
            raise AssertionError("ssh_gang_zipf50k: no fresh gang")
    finally:
        sj.close()
        cl.shutdown()
    shutil.rmtree(os.path.join(root, "ssh-root"), ignore_errors=True)
    return {"hosts": cl.hosts, "transport": "bash -c", "nparts": NPARTS,
            "processes": GANG_PROCS, "lines": len(corpus),
            "words": len(zipf19["line"]), "start_s": start_s,
            "staging_s": cl.stage_s, "kernel_build_s": build_s,
            "cold_wall_s": cold_s, "restart_wall_s": restart_s, **fig}


def phase20_runs(port, hk, wc, corpus, wc_counts, kept, zipf19,
                 root: str, held, device="cuda", keep=None) -> dict:
    """Phase 20's cells on one ``LocalCluster(GANG_PROCS, GANG_DPP)`` on
    the card (P = 8): phase 13's streamed queries as gang jobs, cold and
    warm (PageRank once), over phase 13's stores (``kept``: their paths, oracles and the
    in-process runs), then the SSH cell; the workers' calls held on a
    replay of one TeraSort wave and one streamed PageRank superstep here
    as a gang of threads (``replay_stream_gang``).  With ``keep`` (a
    dict) the cluster is left running under ``keep["cluster"]`` for
    phase 21, which shuts it down."""
    from dryad_tpu_torch.exec import ooc
    from dryad_tpu_torch.plan.planner import plan_query
    from dryad_tpu_torch.runtime import LocalCluster
    from dryad_tpu_torch.runtime.shiplan import serialize_for_cluster
    if TESTS not in sys.path:
        sys.path.insert(0, TESTS)
    import torch_cluster_fns as F
    FakeWebHdfs = loopback_fakes()[1].FakeWebHdfs
    kt, kp, kq, kx = (kept[k] for k in ("tera", "pagerank", "q13", "text"))
    n_nodes = kp["nodes"]
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = TESTS + (os.pathsep + old if old else "")
    os.environ["DRYAD_GANG_PR_NODES"] = str(n_nodes)
    F.PR_NODES = n_nodes
    lines, events = {}, []
    t0 = time.perf_counter()
    cl = LocalCluster(n_processes=GANG_PROCS, devices_per_process=GANG_DPP,
                      fn_modules=("torch_cluster_fns",), device=device,
                      log_dir=os.path.join(root, "workers"))
    start_s = time.perf_counter() - t0
    gj = GangJobs(cl)
    srv = FakeWebHdfs(block_size=64 << 20)
    try:
        gctx = port.Context(cluster=cl, event_log=events.append)
        chunk = kt["chunk"]

        # gang_stream_terasort10m: to a local store cold, to hdfs:// warm
        def sort_to(path):
            def app():
                gctx.read_store_stream(kt["src"], chunk_rows=chunk).order_by(
                    [("key", False)]).to_store(path)
                return read_sorted(ooc, path)
            return app
        def tera_check(got):
            # phase 13's output was held to the input (count, byte order,
            # multiset): the same keys and payloads in the same order (its
            # digest) are the same multiset; rows of equal keys may come
            # in another order, and then the input, made again, is held
            hi, lo = _key_lanes(got[0])
            if not ((hi[:-1] < hi[1:]) | ((hi[:-1] == hi[1:])
                                          & (lo[:-1] <= lo[1:]))).all():
                raise AssertionError("gang_stream_terasort10m: keys not "
                                     "non-decreasing")
            if rows_digest(*got) == kt["out_digest"]:
                return {"rows": len(got[1]), "equal_phase13_rows": True}
            return {**check_terasort_store(
                "gang_stream_terasort10m", got,
                teragen_records(kt["records"], chunk)),
                    "equal_phase13_rows": False}
        url = srv.url + "/gang/sorted"
        line = stream_gang_cell("gang_stream_terasort10m", gj,
                                sort_to(os.path.join(root, "gsorted")),
                                sort_to(url), tera_check,
                                kt["warm_wall_s"], device)
        cut = numpy_gang_cut(ooc, kt["src"], chunk, "key").tolist()
        if line["bounds"] != [cut]:
            raise AssertionError(f"gang_stream_terasort10m: the gang's "
                                 f"bounds {line['bounds']} are not numpy's "
                                 f"cut {cut}")
        uploads = [p for p in srv.files if p.startswith("/gang/sorted/")]
        if len(uploads) != NPARTS + 1 or "/gang/sorted.tmp" in srv.dirs:
            raise AssertionError(f"gang_stream_terasort10m: hdfs:// holds "
                                 f"{sorted(uploads)}")
        t1 = time.perf_counter()
        head = gctx.read_store_stream(kt["small"], chunk_rows=chunk) \
            .order_by([("key", False)]).take(STREAM_TAKE).collect()
        take_s = time.perf_counter() - t1
        sk, sp = kt["small_head"]
        if (head["key"] != [bytes(r) for r in sk]
                or not np.array_equal(head["payload"], sp)):
            raise AssertionError("gang_stream_terasort10m: take(n) after "
                                 "the sort is not the head of the "
                                 "in-process output")
        gj.take()
        line.update({"records": kt["records"], "chunk_rows": chunk,
                     "bounds_equal_numpy_cut": True,
                     "hdfs_parts": len(uploads) - 1, "take_n": STREAM_TAKE,
                     "take_records": kt["small_records"],
                     "take_wall_s": take_s,
                     "cluster_start_s": start_s})
        shutil.rmtree(os.path.join(root, "gsorted"), ignore_errors=True)
        srv.files.clear()
        lines["gang_stream_terasort10m"] = line

        # gang_stream_wordcount1m: the text spooled under
        # cluster_stream_spool_dir, the group partials in the waves
        spool = os.path.join(root, "spool")
        wctx = port.Context(cluster=cl, config=port.JobConfig(
            cluster_stream_spool_dir=spool))

        def wordcount():
            tc = kx["chunk"]
            return (wctx.read_text_stream(kx["path"], chunk_rows=tc,
                                          max_line_len=96)
                    .split_words("line", out_capacity=tc * 10, lower=True)
                    .group_by(["line"], {"n": ("count", None)}).collect())
        line = stream_gang_cell("gang_stream_wordcount1m", gj, wordcount,
                                wordcount, kx["check"], kx["warm_wall_s"],
                                device)
        # the dp level's waves compact the group partials; the dcn
        # level's leg holds no group op, so its buckets spill, as the
        # JAX package's streamed gang does
        if not line["compacted_legs"]:
            raise AssertionError(f"gang_stream_wordcount1m: the group "
                                 f"partials were not compacted in the "
                                 f"waves: {line['spilled_bytes']} bytes "
                                 f"spilled")
        line["spooled_stores"] = len(os.listdir(spool))
        shutil.rmtree(spool, ignore_errors=True)
        lines["gang_stream_wordcount1m"] = line

        # gang_stream_pagerank100k: the edges a cluster re-streaming
        # cache, the ranks resident; one run (its warm rerun was cut for
        # the script's time), then the two caches again: hits
        cache_dir = os.path.join(root, "prcache")
        pctx = port.Context(cluster=cl, event_log=events.append,
                            config=port.JobConfig(ooc_cache_dir=cache_dir))
        nodes = {"node": np.arange(n_nodes, dtype=np.int32),
                 "rank": np.full(n_nodes, 1.0 / n_nodes, np.float32)}

        def caches():
            edges_ds = pctx.read_store_stream(
                kp["path"], chunk_rows=kp["chunk"]).cache()
            return edges_ds, edges_ds.group_by(
                ["src"], {"deg": ("count", None)}).cache()

        def cache_counts(n0):
            kinds = collections.Counter(e.get("event") for e in events[n0:])
            return kinds["ooc_cache_write"], kinds["ooc_cache_hit"]

        def pagerank():
            n0 = len(events)
            edges_ds, deg = caches()

            def body(ranks):
                return (edges_ds
                        .join(deg, ["src"], ["src"], expansion=2.0)
                        .join(ranks, ["src"], ["node"], expansion=2.0)
                        .select(F.pr_contrib)
                        .group_by(["node"], {"s": ("sum", "c")})
                        .select(F.pr_damp))
            out = pctx.do_while(pctx.from_columns(nodes), body,
                                n_iters=STREAM_PR_ITERS).collect()
            cache_events.append(cache_counts(n0))
            return out
        cache_events = []

        def pr_check(out):
            ref = kp["out"]
            o, r = np.argsort(out["node"]), np.argsort(ref["node"])
            if not np.array_equal(np.asarray(out["node"])[o],
                                  np.asarray(ref["node"])[r]):
                raise AssertionError("gang_stream_pagerank100k: nodes differ "
                                     "from the in-process streamed run's")
            a = np.asarray(out["rank"], np.float64)[o]
            b = np.asarray(ref["rank"], np.float64)[r]
            rel = float((np.abs(a - b) / np.abs(b)).max())
            if not rel <= 1e-6:
                raise AssertionError(f"gang_stream_pagerank100k: a rank is "
                                     f"{rel} off the in-process streamed "
                                     f"run's")
            return {**check_pagerank(out, kp["edges"], n_nodes, kp["ref"]),
                    "max_rel_diff_inprocess": rel}
        line = stream_gang_cell("gang_stream_pagerank100k", gj, pagerank,
                                None, pr_check, kp["warm_wall_s"], device)
        n0 = len(events)
        caches()
        cache_events.append(cache_counts(n0))
        gj.take()
        if cache_events != [(2, 0), (0, 2)]:
            raise AssertionError(f"gang_stream_pagerank100k: cache "
                                 f"(writes, hits) cold and warm "
                                 f"{cache_events}")
        line.update({"iters": STREAM_PR_ITERS,
                     "edges": len(kp["edges"]["src"]),
                     "cache_writes_hits": cache_events})
        pr_stores = cache_stores(cache_dir)
        lines["gang_stream_pagerank100k"] = line

        # gang_stream_q13_1m5: right and full joins with the customers,
        # and a zip of two selects of one store
        orders, cust = kq["orders"], kq["cust"]

        def q13(how):
            def app():
                return (gctx.read_store_stream(kq["path"],
                                               chunk_rows=kq["chunk"])
                        .select(F.q13_hit)
                        .join(gctx.from_columns(cust), ["custkey"], how=how)
                        .group_by(["custkey"], {"n": ("sum", "hit"),
                                                "rows": ("count", None)})
                        .collect())
            return app
        q13_lines = {}
        for how in ("right", "full"):
            ln = stream_gang_cell(f"gang_stream_q13_1m5 {how}", gj,
                                  q13(how), q13(how), kq["check"],
                                  kq["warm_wall_s"][how], device)
            if ln["unmatched_customers"] != len(cust["custkey"]) - len(
                    np.unique(orders["custkey"])):
                raise AssertionError("gang_stream_q13_1m5: customers with no "
                                     "order missing")
            q13_lines[how] = ln

        def zipped(ctx):
            s = ctx.read_store_stream(kq["path"], chunk_rows=kq["chunk"])
            return s.select(F.q13_okey).zip_with(
                s.select(F.q13_cust)).collect()
        t1 = time.perf_counter()
        z = zipped(gctx)
        zip_s = time.perf_counter() - t1
        zreplies, _ = gj.take()
        lz = zipped(port.Context(device=device, nparts=NPARTS))
        ok_, ck = np.asarray(z["okey"]), np.asarray(z["ck"])
        if (len(ok_) != len(orders["okey"])
                or not np.array_equal(np.sort(ok_), orders["okey"])
                or not np.array_equal(ck, orders["custkey"][ok_])):
            raise AssertionError("gang_stream_q13_1m5: the zip does not pair "
                                 "each order with its own customer")
        lo = np.argsort(lz["okey"])
        if not np.array_equal(np.sort(ok_), np.asarray(lz["okey"])[lo]) or \
                not np.array_equal(ck[np.argsort(ok_)],
                                   np.asarray(lz["ck"])[lo]):
            raise AssertionError("gang_stream_q13_1m5: the zip differs from "
                                 "the in-process streamed run's")
        zfig = stream_gang_figures("gang_stream_q13_1m5 zip", zreplies,
                                   device)
        lines["gang_stream_q13_1m5"] = {
            **q13_lines, "zip": {"rows": len(ok_), "wall_s": zip_s,
                                 **{k: zfig[k] for k in (
                                     "waves", "exchange_attempts",
                                     "worker_launches", "staged")}}}
    except BaseException:
        cl.shutdown()
        raise
    finally:
        srv.close()
        gj.close()
        if keep is None:
            cl.shutdown()
        else:
            keep["cluster"] = cl
        os.environ.pop("DRYAD_GANG_PR_NODES", None)
        if old is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old

    # the SSH backend (PYTHONPATH of the remote shell: the staged root)
    lines["ssh_gang_zipf50k"] = ssh_gang_cell(port, wc, corpus, wc_counts,
                                              zipf19, root, device)

    # the workers' kernel calls at their shapes: one TeraSort wave (phase
    # 13's 1,000,000 records: one chunk a partition) and one PageRank
    # superstep over the cells' cached edges and out-degrees, replayed
    # here as a gang of threads, every call held against the plain
    # versions
    import torch
    torch.cuda.empty_cache()
    cctx = port.Context(cluster=cl)
    tera_node = cctx.read_store_stream(kt["small"], chunk_rows=chunk) \
        .order_by([("key", False)]).node
    edges_c = cctx.read_store_stream(pr_stores[("dst", "src")],
                                     chunk_rows=kp["chunk"])
    deg_c = cctx.read_store_stream(pr_stores[("deg", "src")],
                                   chunk_rows=kp["chunk"])
    step_node = (edges_c.join(deg_c, ["src"], ["src"], expansion=2.0)
                 .join(cctx.from_columns(nodes), ["src"], ["node"],
                       expansion=2.0)
                 .select(F.pr_contrib).group_by(["node"], {"s": ("sum", "c")})
                 .select(F.pr_damp)).node
    plans = [serialize_for_cluster(plan_query(n, NPARTS))
             for n in (tera_node, step_node)]
    captured, replayed, rstats = replay_stream_gang(port, hk, plans, device)
    if len(rstats) != 2 * GANG_PROCS or rstats[0]["waves"] != 1 or \
            rstats[0]["bounds"] != rstats[1]["bounds"]:
        raise AssertionError(f"stream gang replay: {rstats}")
    att = collections.Counter()
    for st in rstats:
        att.update(st["attempts"])
    # (a CPU rehearsal's counting plain versions count here too)
    if (replayed["slot_expand"] != att["hash"] + att["range"]
            or replayed["slot_compact"] != att["hash"] + att["range"]
            + att["broadcast"]):
        raise AssertionError(f"stream gang replay: launches {replayed} for "
                             f"attempts {dict(att)}")
    errs = hold_run(hk, "stream gang replay", captured)
    shapes = {k: [tuple(a.shape) for a in calls[0][1]
                  if hasattr(a, "shape")] for k, calls in captured.items()}
    del captured
    total = dict.fromkeys(TPU_KERNEL, 0)
    for label in ("gang_stream_terasort10m", "gang_stream_wordcount1m",
                  "gang_stream_pagerank100k"):
        for r in lines[label].pop("_replies"):
            for w in r["workers"].values():
                total = add_launches(total, w["launches"])
    for how in ("right", "full"):
        for r in lines["gang_stream_q13_1m5"][how].pop("_replies"):
            for w in r["workers"].values():
                total = add_launches(total, w["launches"])
    for w in lines["gang_stream_q13_1m5"]["zip"]["worker_launches"].values():
        total = add_launches(total, w)
    missed = [k for k in TPU_KERNEL if not total[k] or not replayed[k]]
    if missed and device == "cuda":
        raise AssertionError(f"phase 20: {missed} not launched by the "
                             f"workers or not replayed")
    held("stream_gang", total, errs=errs)
    lines["stream_gang_replay"] = {"replay_launches": replayed,
                                   "max_abs_err": errs,
                                   "first_call_shapes": shapes,
                                   "worker_launches": total}
    return lines


# ---------------------------------------------------------------------------
# phase 21: multi-axis meshes and hierarchical group aggregation

MESH_SHAPES = {"mesh2d": dict(hosts=2), "mesh3d": dict(hosts=2, pods=2)}
LEVEL_LABELS = {"mesh2d": ["dp", "dcn"], "mesh3d": ["dp", "host", "dcn"]}
ADAPT_KEYS = 500     # the adaptive job's first group: its rows are under
                     # JobConfig.adapt_agg_collapse_rows, so it collapses


def combine_stages(log) -> list:
    """The labels of a run's exchanging stages, in order."""
    return [e["label"] for e in log if e["exchange"]]


def run_on_mesh(port, hk, mesh, build, device="cuda") -> tuple:
    """``build(ctx)`` (load, query, collect) in a Context on ``mesh``:
    counters zeroed just before, read just after, every kernel call
    captured.  Returns (table, launches, captured, wall_s, stage log)."""
    import torch
    ctx = port.Context(mesh=mesh)
    hk.reset_launches()
    hk.capture = {}
    t0 = time.perf_counter()
    try:
        out = build(ctx)
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        captured, hk.capture = hk.capture, None
    return (out, dict(hk.launches), captured, time.perf_counter() - t0,
            list(ctx.executor.stage_log))


def check_one_axis(label, out, flat, exact=("n", "lo", "hi")) -> None:
    """The columns ``exact`` (counts, min, max) of a hierarchical run
    equal the one-axis run's (phase 4's) key for key."""
    o, f = np.argsort(out["k"]), np.argsort(flat["k"])
    for c in ("k",) + tuple(exact):
        if not np.array_equal(np.asarray(out[c])[o],
                              np.asarray(flat[c])[f]):
            raise AssertionError(f"{label}: column {c} differs from the "
                                 f"one-axis run's")


def adapt_pairs(rows: int, seed: int = 21) -> dict:
    rng = np.random.RandomState(seed)
    return {"k": rng.randint(0, ADAPT_KEYS, rows).astype(np.int32),
            "v": rng.randint(0, 10, rows).astype(np.int32)}


def two_groups(ds):
    """Group sums, then the count of each sum: a merge chain whose first
    level reads at most ADAPT_KEYS rows (the aggregation-tree collapse)."""
    return ds.group_by(["k"], {"s": ("sum", "v")}).group_by(
        ["s"], {"n": ("count", None)})


def two_groups_oracle(data) -> dict:
    s = np.bincount(data["k"], weights=data["v"], minlength=ADAPT_KEYS)
    s = s[np.bincount(data["k"], minlength=ADAPT_KEYS) > 0].astype(np.int64)
    vals, cnt = np.unique(s, return_counts=True)
    return dict(zip(vals.tolist(), cnt.tolist()))


def phase21_runs(port, hk, gbr_data, variants, flat_outs, wc, corpus,
                 wc_counts, held, root: str, device="cuda",
                 cluster=None) -> dict:
    """Phase 21's cells (see the module docstring): GroupByReduce's app
    on a (dcn, dp) and a (dcn, host, dp) mesh and its Decomposable and
    WordCount on the (dcn, dp) one, each cold with every kernel call
    held, then warm; the app on a gang whose mesh is (dcn, dp) with dcn
    the process boundary, against the in-process (dcn, dp) run; one
    ``adaptive="on"`` gang job whose aggregation tree collapses.  The
    gang is ``cluster`` (phase 20's, which its caller stops) or a
    ``LocalCluster(GANG_PROCS, GANG_DPP)`` of its own.  The gang
    workers' calls held on a replay of the gang's app here as a gang of
    threads (``replay_gang``)."""
    import torch
    from dryad_tpu_torch.runtime import LocalCluster
    lines = {}
    meshes = {name: port.make_mesh(device, NPARTS, **kw)
              for name, kw in MESH_SHAPES.items()}
    per_part = -(-len(corpus) // NPARTS)

    def wordcount(ctx):
        return wc.wordcount_query(
            ctx.from_columns({"line": corpus}, str_max_len=96),
            tokens_per_partition=per_part * 10).collect()

    def wc_check(label, out):
        if dict(zip(out["line"], (int(v) for v in out["n"]))) != wc_counts:
            raise AssertionError(f"{label}: counts differ from phase 3's "
                                 f"(the Counter oracle's)")
        return {"words": len(out["line"])}

    def gbr_check(vname):
        def check(label, out):
            check_gbr(label, out, gbr_data, variants[vname][2])
            check_one_axis(label, out, flat_outs[vname])
            return {"groups": len(out["k"])}
        return check

    def gbr_build(vname):
        return lambda c: variants[vname][1](c.from_columns(gbr_data)) \
            .collect()

    rows = len(gbr_data["k"])
    cells = [("mesh2d_app10k", "mesh2d", gbr_build("app10k"),
              gbr_check("app10k"), "groupby", TPU_KERNEL, rows),
             ("mesh3d_app10k", "mesh3d", gbr_build("app10k"),
              gbr_check("app10k"), "groupby", TPU_KERNEL, rows),
             ("mesh2d_decomposable10k", "mesh2d",
              gbr_build("decomposable10k"), gbr_check("decomposable10k"),
              "dgroupby", EXCHANGE, rows),
             ("mesh2d_wordcount", "mesh2d", wordcount, wc_check, "groupby",
              EXCHANGE, len(corpus))]
    for label, mname, build, check, prefix, need, n_rows in cells:
        out, launches, captured, cold_s, log = run_on_mesh(
            port, hk, meshes[mname], build, device)
        sizes = check(label, out)
        held(label, launches, captured)
        del captured
        stages = exchanging_stages([log])
        want = [f"{prefix}-{ax}" for ax in LEVEL_LABELS[mname]]
        if combine_stages(log) != want:
            raise AssertionError(f"{label}: combine stages "
                                 f"{combine_stages(log)}, not {want}")
        zero = [k for k in need if launches[k] == 0]
        if zero:
            raise AssertionError(f"{label}: kernels never launched: {zero}")
        check_per_exchange(label, launches, exchange_attempts(stages),
                           probes=probes_run(stages))
        t0 = time.perf_counter()
        check(label, build(port.Context(mesh=meshes[mname])))
        warm_s = time.perf_counter() - t0
        lines[label] = {**sizes, "mesh": dict(meshes[mname].axes),
                        "rows": n_rows, "combine_stages": want,
                        "launches": launches,
                        "exchanging_stages": stages, "cold_wall_s": cold_s,
                        "warm_wall_s": warm_s}
        del out

    # the gang: LocalCluster(2, 4) on the card, dcn = the process boundary
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cl = cluster or LocalCluster(
        n_processes=GANG_PROCS, devices_per_process=GANG_DPP,
        device=device, log_dir=os.path.join(root, "workers"))
    start_s = None if cluster else time.perf_counter() - t0
    gj = GangJobs(cl)
    events = []
    try:
        gctx = port.Context(cluster=cl)
        if (gctx.hosts, gctx.levels) != (GANG_PROCS, ("dp", "dcn")):
            raise AssertionError(f"gang_mesh_app10k: the gang plans levels "
                                 f"{gctx.levels}")
        app = gbr_build("app10k")

        def gang_check(out, local):
            _tables_equal("gang_mesh_app10k", out, local)
            return gbr_check("app10k")("gang_mesh_app10k", out)
        line = gang_cell("gang_mesh_app10k", gj, lambda: app(gctx),
                         lambda: app(port.Context(mesh=meshes["mesh2d"])),
                         gang_check, device)
        for w, info in line["_replies"][0]["workers"].items():
            got = {e["label"]: e["staged_bytes"] for e in info["stage_log"]}
            if (combine_stages(info["stage_log"])
                    != ["groupby-dp", "groupby-dcn"]
                    or any(got["groupby-dp"]) or not all(got["groupby-dcn"])):
                raise AssertionError(f"gang_mesh_app10k worker {w}: staged "
                                     f"bytes {got}")
            line.setdefault("staged_bytes", {})[w] = got
        line["dp_hop_staged_bytes"] = 0
        line["cluster_start_s"] = start_s
        lines["gang_mesh_app10k"] = line

        # adaptive="on": every worker sees the gang's per-partition rows,
        # so every worker collapses the same tree
        adata = adapt_pairs(len(gbr_data["k"]))
        want = two_groups_oracle(adata)
        on = port.Context(cluster=cl, event_log=events.append,
                          config=port.JobConfig(adaptive="on"))
        off = port.Context(cluster=cl)
        gj.take()
        t1 = time.perf_counter()
        out_on = two_groups(on.from_columns(adata)).collect()
        on_s = time.perf_counter() - t1
        replies, _ = gj.take()
        t1 = time.perf_counter()
        out_off = two_groups(off.from_columns(adata)).collect()
        off_s = time.perf_counter() - t1
        gj.take()
        fig = gang_figures("gang_adaptive_collapse", replies, device)
        rewrites = [e for e in events if e.get("event") == "graph_rewrite"]
        counts = {w: info.get("graph_rewrites")
                  for w, info in replies[0]["workers"].items()}
        got = dict(zip((int(x) for x in out_on["s"]),
                       (int(x) for x in out_on["n"])))
        if (not rewrites or len(set(counts.values())) != 1
                or counts[0] != len(rewrites)
                or "agg_tree_collapse" not in {e["kind"] for e in rewrites}
                or got != want or _row_set(out_on) != _row_set(out_off)):
            raise AssertionError(f"gang_adaptive_collapse: rewrites "
                                 f"{[e.get('kind') for e in rewrites]}, "
                                 f"per worker {counts}, result equal to "
                                 f"the oracle: {got == want}")
        lines["gang_adaptive_collapse"] = {
            "rows": len(adata["k"]), "keys": ADAPT_KEYS,
            "groups": len(got), "rewrites": [e["kind"] for e in rewrites],
            "worker_rewrites": counts, "on_wall_s": on_s,
            "off_wall_s": off_s, **fig}
    finally:
        gj.close()
        if cluster is None:
            cl.shutdown()

    # the workers' kernel calls at their shapes: the gang's app replayed
    # here as a gang of threads (both hops, the dcn one across the
    # threads), every call held against the plain versions
    torch.cuda.empty_cache()
    captured, replayed = replay_gang(port, hk, [app], device)
    errs = hold_run(hk, "mesh gang replay", captured)
    del captured
    total = dict.fromkeys(TPU_KERNEL, 0)
    for label in ("gang_mesh_app10k", "gang_adaptive_collapse"):
        lines[label].pop("_replies", None)
        for w in lines[label]["worker_launches"].values():
            total = add_launches(total, w)
    missed = [k for k in TPU_KERNEL if not total[k] or not replayed[k]]
    if missed and device == "cuda":
        raise AssertionError(f"phase 21: {missed} not launched by the "
                             f"workers or not replayed")
    held("mesh_gang", total, errs=errs)
    lines["mesh_gang_replay"] = {"replay_launches": replayed,
                                 "max_abs_err": errs,
                                 "worker_launches": total}
    return lines


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


# launches of the one-element add that close a padded profile window:
# the profiler drops a window's last device records too (the run's last
# 218 and a 64-launch pad's all in one window)
PROFILE_TAIL_PAD = 8192


# padded windows taken at most for one measurement: a window in which
# the profiler dropped device records of the run is discarded, its loss
# printed, and the run profiled again, since the loss comes and goes
# between like windows (pagerank100k's window lost records in two whole
# runs of this script and none in three others)
PROFILE_WINDOWS = 3


def padded_profile(run, activities, label: str):
    """``run()`` under torch.profiler with ``activities`` (CUDA among
    them): ``(profiler, run's result, the pads' correlation ids)``.  The
    window opens with the executor's pad (``_PROFILE_PAD_LAUNCHES``
    launches of a one-element add, then a sync), since the profiler can
    drop a window's first device records, and closes with
    ``PROFILE_TAIL_PAD`` more after the run's sync; the pads' records are
    left out by correlation id.  Before each window the caching
    allocator's free blocks go back to the card (``empty_cache``), room
    for the profiler's device buffers.  A window in which a kernel launch
    of the run has no device record is discarded with a
    ``profile_window_discarded`` line and the run profiled again, at most
    ``PROFILE_WINDOWS`` windows; when every window lost records, this
    fails, naming the first such launches of the last."""
    import torch
    from torch.profiler import profile

    from dryad_tpu_torch.exec.executor import _PROFILE_PAD_LAUNCHES
    pad = torch.zeros(1, device="cuda")
    for window in range(1, PROFILE_WINDOWS + 1):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with profile(activities=activities) as prof:
            for _ in range(_PROFILE_PAD_LAUNCHES):
                pad.add_(1)
            torch.cuda.synchronize()
            out = run()
            torch.cuda.synchronize()
            for _ in range(PROFILE_TAIL_PAD):
                pad.add_(1)
            torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        recorded, launched = set(), []
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                recorded.add(e.correlation_id())
            elif "Launch" in e.name() and "Kernel" in e.name():
                launched.append((e.correlation_id(), e.name()))
        launched.sort()
        own = launched[_PROFILE_PAD_LAUNCHES:len(launched) - PROFILE_TAIL_PAD]
        lost = [(i, name) for i, (c, name) in enumerate(own)
                if c not in recorded]
        if own and not lost:
            return prof, out, {c for c, _ in launched[:_PROFILE_PAD_LAUNCHES]
                               + launched[len(launched) - PROFILE_TAIL_PAD:]}
        print(json.dumps({"profile_window_discarded": label,
                          "window": window, "lost": len(lost),
                          "launches": len(own),
                          "first_lost": lost[:1]}), flush=True)
        del prof, events, out
    raise AssertionError(
        f"{label}: every one of {PROFILE_WINDOWS} profile windows lacks "
        f"records: {len(lost)} of the last window's {len(own)} kernel "
        f"launches have no device record, the first (index, launch) "
        f"{lost[:5]}")


def profile_window(fn, calls: int = 20, label: str = "window") -> list:
    """torch.profiler over ``calls`` calls of ``fn`` and nothing else, in
    a padded window (``padded_profile``): [(kernel or memset name,
    count, device µs in all)].  One call runs before the window."""
    import torch
    from torch.profiler import ProfilerActivity

    fn()

    def calls_of():
        for _ in range(calls):
            fn()

    prof, _, pad = padded_profile(
        calls_of, [ProfilerActivity.CPU, ProfilerActivity.CUDA], label)
    count, us = collections.Counter(), collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and e.correlation_id() not in pad):
            count[e.name()] += 1
            us[e.name()] += e.duration_ns() / 1e3
    return [(k, count[k], us[k]) for k in count]


def profile_calls(name: str, fn, calls: int = 20,
                  per_call: int = 1) -> dict:
    """The row's kernel time per call at the timed shape, and the device
    events (kernels and memsets) per call, in all and by name, from one
    padded window.  The time per call is the mean of the kernel's
    recorded events times ``per_call``, the kernel's launches in one
    call of ``fn``.  A window that recorded none of the kernel's events
    fails."""
    ours = n_ours = events = 0
    by_name = {}
    for key, count, us in profile_window(fn, calls, label=name):
        events += count
        by_name[key[:80]] = count / calls
        if any(s in key for s in DEVICE_NAMES[name]):
            ours += us
            n_ours += count
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


def profile_path(run, label, out_dir, pack: bool = True) -> dict:
    """``profile_run`` (one padded window), failing when a port kernel
    launched in the run shows no profiled device time or (with ``pack``)
    the pack ranges show none."""
    prof = profile_run(run, label, out_dir, pack)
    ours = prof.get("port_kernels_ms") or {}
    missing = [k for k, n in prof["launches"].items()
               if n and not ours.get(k)]
    if missing or (pack and not prof.get("pack_kernels_us")):
        raise AssertionError(
            f"{label}: {missing or 'the pack ranges'} show no profiled "
            f"device time")
    return prof


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


def time_hash_shape(hashing, n: int = 1 << 25) -> dict:
    """``hash_keys`` at TPC-H Q3's group-by key shape, three int32 keys,
    at ``n`` rows: the kernel and its plain version on the card, held
    equal, timed (CUDA events, and the kernel's device time from a
    profile), beside the bound of its bytes and operations."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(25)
    cols = [torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                          device="cuda", generator=g) for _ in range(3)]
    got, want = hashing._hash_keys(cols), hashing.hash_columns(cols)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("hash_keys: three int32 keys, kernel != plain")
    del got, want
    nbytes, ops = hash_work(cols)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    kernel = functools.partial(hashing._hash_keys, cols)
    return {"rows": n, "keys": "3 x int32", "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(functools.partial(hashing.hash_columns,
                                                  cols), reps=3),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            **profile_calls("hash_keys", kernel),
            "bytes": nbytes, "ops": ops}


def time_hash_keys(hashing, runs, calls, prof, card) -> dict:
    """The kernels line's row of ``hash_keys``, timed on the largest of
    the app10k run's calls (``calls``: their key columns) with the
    kernel, its plain version on the card and the bound of that call's
    inputs (``hash_work``: bytes / 3.35 TB/s or operations / 67 TOP/s,
    the larger, as the five's rows), its device time per launch from the
    profiled warm app10k run (``prof``).  ``launches``: the held runs'."""
    cols = max(calls, key=lambda c: _hash_rows(c) * len(c))
    per_run = {r: {"launches": l["hash_keys"], "max_abs_err": e["hash_keys"]}
               for r, (l, e) in runs.items() if "hash_keys" in e}
    prof_per_launch = per_launch_us(prof, "hash_keys")
    if not prof["launches"]["hash_keys"] or prof_per_launch is None:
        raise AssertionError("hash_keys: no launch or no profiled device "
                             "time in the profiled app10k run")
    nbytes, ops = hash_work(cols)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    kernel = functools.partial(hashing._hash_keys, cols)
    return {
        "name": "hash_keys", "route": "cuda",
        "source": "dryad_tpu_torch/ops/csrc/hash_keys.cu",
        "replaces": None,
        "launches": sum(r["launches"] for r in per_run.values()),
        "max_abs_err": max(r["max_abs_err"] for r in per_run.values()),
        "ms": cuda_ms(kernel),
        "plain_ms": cuda_ms(functools.partial(hashing.hash_columns, cols)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "runs": per_run,
        "profiled_launches": prof["launches"]["hash_keys"],
        "profiled_device_ms_per_launch": prof_per_launch / 1e3,
        **profile_calls("hash_keys", kernel),
        "host_enqueue_us": host_enqueue_us(kernel),
        "timed_on": "app10k",
        "shape": [[_hash_rows([c]), c.max_len, "str"] if hasattr(
            c, "max_len") else [*c.shape, str(c.dtype)] for c in cols],
        "bytes": nbytes, "ops": ops,
        # TPC-H Q3's group-by key shape, apart from the path
        "three_int32_keys": time_hash_shape(hashing),
        "card": card,
    }


def time_seg_scan(hk, runs, dropped, card, n: int = 22_500_000) -> dict:
    """The kernels line's row of ``seg_scan``.  ``launches`` and
    ``max_abs_err``: the held main-path runs' (``runs``, each scan call
    made again through the kernel and the plain version by
    ``hold_seg_scans``; ``dropped``: calls past ``SEG_HOLD_BYTES``, not
    held).  Timed at TPC-H Q1's partial group-by in one partition: ``n``
    rows of start flags (four segments, Q1's four groups), the int32
    count leaf and five int64 sums, held equal to the plain version on
    the card, then timed (CUDA events; its three launches' device time
    from a profile) beside the bound of its bytes: the flags and each
    leaf read once, each output written once (``design_bytes``: what the
    kernel moves, reading the inputs twice)."""
    import torch
    per_run = {r: {"launches": l["seg_scan"], "max_abs_err": e["seg_scan"]}
               for r, (l, e) in runs.items() if l.get("seg_scan")}
    if not per_run:
        raise AssertionError("seg_scan: no held main-path run launched it")
    g = torch.Generator(device="cuda").manual_seed(27)
    starts = torch.zeros(n, dtype=torch.bool, device="cuda")
    starts[torch.arange(4, device="cuda") * (n // 4)] = True
    cnt = (torch.arange(n, device="cuda") < n - n // 50).to(torch.int32)
    leaves = [(cnt, torch.add)] + [
        (torch.randint(0, 10**12, (n,), dtype=torch.int64, device="cuda",
                       generator=g), torch.add) for _ in range(5)]
    before = hk.launches["seg_scan"]
    got = hk.seg_scan_multi(leaves, starts)
    launches = hk.launches["seg_scan"] - before
    want = hk.seg_scan_multi_plain(leaves, starts)
    torch.cuda.synchronize()
    if launches != 1 or not all(torch.equal(a, b)
                                for a, b in zip(got, want)):
        raise AssertionError(f"seg_scan: Q1's shape, {launches} launches, "
                             f"kernel != plain")
    del got, want
    es = sum(v.element_size() for v, _ in leaves)
    nbytes = n * (1 + 2 * es)
    ops = n * len(leaves)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    kernel = functools.partial(hk.seg_scan_multi, leaves, starts)
    calls = 20
    by_kernel = {sub: us / calls
                 for key, _count, us in profile_window(kernel, calls,
                                                       "seg_scan")
                 for sub in DEVICE_NAMES["seg_scan"] if sub in key}
    device_ms = sum(by_kernel.values()) / 1e3
    return {
        "name": "seg_scan", "route": "cuda",
        "source": "dryad_tpu_torch/ops/csrc/seg_scan.cu",
        "replaces": None,
        "launches": sum(r["launches"] for r in per_run.values()),
        "max_abs_err": max(r["max_abs_err"] for r in per_run.values()),
        "runs": per_run, "calls_not_held": dropped,
        "ms": cuda_ms(kernel),
        "plain_ms": cuda_ms(functools.partial(
            hk.seg_scan_multi_plain, leaves, starts), reps=3),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "device_ms": device_ms,
        "device_us_by_kernel": by_kernel,
        "share": max(t_bytes, t_ops) / device_ms,
        **profile_calls("seg_scan", kernel, per_call=3),
        "host_enqueue_us": host_enqueue_us(kernel),
        "timed_on": "q1_partition",
        "shape": [[n, "bool"], [n, "int32"], *([[n, "int64"]] * 5)],
        "bytes": nbytes, "design_bytes": n * (2 * (1 + es) + es),
        "ops": ops, "card": card,
    }


def profile_run(run, label, out_dir, pack: bool = True) -> dict:
    """Device time by kernel over one warm run of a path, in a padded
    window (``padded_profile``; the written table includes the pad's
    adds, the numbers leave them out).
    ``run()`` returns (table, launches, load_s, query_s).  ``pack``
    also traces the host side, which the pack-side ranges need; without
    it only the device is traced (PageRank's warm run issues hundreds of
    thousands of host ops, whose events the profiler is slow to
    process)."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CUDA]
    if pack:
        acts.insert(0, ProfilerActivity.CPU)
    prof, (_out, launches, load, query), pad = padded_profile(
        run, acts, label)
    wall = load + query
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))
    dev_ms, dev_n = collections.Counter(), collections.Counter()
    for e in prof.profiler.kineto_results.events():
        # the pack range shows on the device timeline too, as a span
        # over its kernels: not device time of its own
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and e.correlation_id() not in pad
                and e.name() != PACK_RANGE):
            dev_ms[e.name()] += e.duration_ns() / 1e6
            dev_n[e.name()] += 1
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
    from dryad_tpu_torch.ops import hashing
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

    scans = seg_scan_calls(hk)   # the group op's scans, held in held()

    def held(label, launches, captured=None, errs=None):
        """Record a main-path run: its launches and its calls held
        (``captured``), or the largest errors of calls already held
        (``errs``); its segmented scans held too, their launches counted
        against its counters where the run's own (``captured``)."""
        if errs is None:
            errs = hold_run(hk, label, captured)
        seg = hold_seg_scans(hk, label, launches, scans,
                             count=captured is not None)
        if "seg_scan" in launches:
            errs = {**errs, "seg_scan": seg or 0.0}
        runs[label] = (launches, errs)
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
    flat_outs = {}   # phase 4's tables, for phase 21's meshes
    for vname, (n_keys, query, cols) in variants.items():
        data = gbr.gen_pairs(a.rows, n_keys, seed=0)
        hk.capture = {}
        with hash_calls(hashing) as hashed:
            out, launches, load, qs, logs = run_gbr(port, hk, data, query)
        captured, hk.capture = hk.capture, None
        check_gbr(vname, out, data, cols)
        flat_outs[vname] = out
        held(vname, launches, captured)
        runs[vname][1]["hash_keys"] = hold_hashes(hashing, vname, launches,
                                                  hashed)
        if vname == "app10k":   # its largest call, for the kernels line
            app_hashes = [max(hashed["kernel"],
                              key=lambda c: _hash_rows(c) * len(c))]
        del hashed
        zero = [k for k in (HASHING if vname == "app10k" else EXCHANGE)
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

    # Q1's aggregate set over int64 decimals: the group op's scan
    # lowering in both stages (app10k above reaches it only in its final
    # merge of two min / max columns)
    q1d = q1_int64_data(a.rows)
    hk.capture = {}
    out, launches, load, qs, _ = run_app(
        port, hk, lambda c: q1_int64_query(c, q1d))
    captured, hk.capture = hk.capture, None
    groups = check_q1_int64(out, q1d)
    held("q1int64", launches, captured)
    del captured, out, q1d
    if launches["seg_scan"] < NPARTS:
        raise AssertionError(f"q1int64: seg_scan launched "
                             f"{launches['seg_scan']} times, not once per "
                             f"partition in the partial stage at least")
    emit({"q1int64": {"rows": a.rows, "groups": groups, "nparts": NPARTS,
                      "launches": launches, "cold_wall_s": load + qs},
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
    # the executor's log), then warm
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
        # (skewjoin6m's profiled warm run was cut for the script's time)
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
              "rows_per_s": rows / (wload + wquery), "card": card})

    # phase 10: each run cold (its calls held, its launches checked
    # against the executor's log, slot probes apart), then warm in the
    # cold run's context (measured slots from the slot feedback); a vmap
    # fallback to a Python loop over groups is an error
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
                # (unnest6m's profiled warm run, with its path_bound line,
                # was cut for the script's time)
                wout, wlaunches, wload, wquery, wruns = run_app(
                    port, hk, warm_app, ctx=ctx)
                wsizes = check(wout, wruns, True)
                del wout
                line.update({
                    "warm": wsizes, "warm_launches": wlaunches,
                    "warm_exchanging_stages":
                        loop_stages(wruns)["outside_loop"],
                    "warm_wall_s": wload + wquery, "warm_load_s": wload,
                    "warm_query_s": wquery,
                    "rows_per_s": len(li_np["okey"]) / (wload + wquery)})
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
    tmp13 = tempfile.mkdtemp(prefix="phase13-", dir=a.out)
    # phase 20 streams phase 13's stores again: they stay until it ends
    atexit.register(shutil.rmtree, tmp13, True)
    kept13 = {}
    t13 = time.perf_counter()
    thirteen = phase13_runs(port, hk, sizes13, tmp13, corpora["bench12"],
                            wc_counts["bench12"], held, keep=kept13)
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
    fourteen = phase14_runs(port, hk, a.lineitems, held, a.out, tables14)
    for label, line in fourteen.items():
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
    new = set(runs) - before
    launches15 = {k: sum(runs[r][0][k] for r in new) for k in TPU_KERNEL}
    unheld = set(TPU_KERNEL) - {k for r in new for k in runs[r][1]}
    if unheld or not all(launches15.values()):
        raise AssertionError(f"phase 15: launches {launches15}, no call of "
                             f"{sorted(unheld)} held")
    emit({"phase": "observability", "launches": launches15,
          "seconds": time.perf_counter() - t15, "card": card})

    # phase 16: incremental queries over a growing local store and the
    # network stores on loopback fakes; stores under --out, deleted at
    # the end of the phase
    before = set(runs)
    t16 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase16-", dir=a.out)
    try:
        sixteen = phase16_runs(port, hk, wc, a.lineitems // INC_SCALE, tmp,
                               corpora["bench12"], wc_counts["bench12"],
                               held)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for label, line in sixteen.items():
        emit({"phase16": label, **line, "card": card})
    new = set(runs) - before
    launches16 = {k: sum(runs[r][0][k] for r in new) for k in TPU_KERNEL}
    unheld = set(TPU_KERNEL) - {k for r in new for k in runs[r][1]}
    if unheld or not all(launches16.values()):
        raise AssertionError(f"phase 16: launches {launches16}, no call of "
                             f"{sorted(unheld)} held")
    emit({"phase": "incremental_remote", "launches": launches16,
          "seconds": time.perf_counter() - t16, "card": card})

    # phase 17: the job service on the in-process fleet over phase 14's
    # catalog; services and stores under --out, deleted at the end
    before = set(runs)
    t17 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase17-", dir=a.out)
    try:
        seventeen = phase17_runs(
            port, hk, tables14, a.lineitems, tmp, held,
            fourteen["sqlq3_6m_off"]["warm_wall_median_s"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for label, line in seventeen.items():
        emit({"phase17": label, **line, "card": card})
    new = set(runs) - before
    launches17 = {k: sum(runs[r][0][k] for r in new) for k in TPU_KERNEL}
    unheld = set(TPU_KERNEL) - {k for r in new for k in runs[r][1]}
    if unheld or not all(launches17.values()):
        raise AssertionError(f"phase 17: launches {launches17}, no call of "
                             f"{sorted(unheld)} held")
    emit({"phase": "service", "launches": launches17,
          "seconds": time.perf_counter() - t17, "card": card})

    # phase 18: worker processes on the card (the task farm, the job
    # service's cluster fleet, forensics) and the chaos harness; the
    # workers and the chaos victim share the card with this process, so
    # its cached blocks go back first
    torch.cuda.empty_cache()
    before = set(runs)
    t18 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase18-", dir=a.out)
    try:
        eighteen = phase18_runs(port, hk, tables14, tmp, held, seventeen)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del tables14, fourteen
    for label, line in eighteen.items():
        emit({"phase18": label, **line, "card": card})
    new = set(runs) - before
    launches18 = {k: sum(runs[r][0][k] for r in new) for k in TPU_KERNEL}
    unheld = set(TPU_KERNEL) - {k for r in new for k in runs[r][1]}
    if unheld or not all(launches18.values()):
        raise AssertionError(f"phase 18: launches {launches18}, no call of "
                             f"{sorted(unheld)} held")
    emit({"phase": "cluster", "launches": launches18,
          "worker_launches": {r: runs[r][0] for r in new
                              if r != "chaos_seed3"},
          "seconds": time.perf_counter() - t18, "card": card})

    # phase 19: the gang, SPMD jobs across two worker processes on the
    # card (P = 8) against the same queries in this process; stores under
    # --out, deleted at the end
    torch.cuda.empty_cache()
    t19 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase19-", dir=a.out)
    kept19 = {}
    try:
        nineteen = phase19_runs(
            port, hk, wc, ts, corpora["zipf50k"], wc_counts["zipf50k"],
            (tera_data, tera_sml), edges, a.nodes, pr, a.lineitems, tmp,
            held, keep=kept19)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for label, line in nineteen.items():
        emit({"phase19": label, **line, "card": card})
    emit({"phase": "gang", "worker_launches": runs["gang"][0],
          "max_abs_err": runs["gang"][1],
          "seconds": time.perf_counter() - t19, "card": card})

    # phase 20: the streamed gang (phase 13's streamed queries as chunk
    # waves across two worker processes, over phase 13's stores) and the
    # SSH backend; phase 13's stores deleted at its end, its own under
    # --out at phase 21's
    torch.cuda.empty_cache()
    t20 = time.perf_counter()
    tmp20 = tempfile.mkdtemp(prefix="phase20-", dir=a.out)
    # phase 21 runs its gang cells on phase 20's cluster (one start less),
    # whose logs stay until it ends; this process stops it at exit at the
    # latest
    atexit.register(shutil.rmtree, tmp20, True)
    kept20 = {}
    try:
        twenty = phase20_runs(port, hk, wc, corpora["zipf50k"],
                              wc_counts["zipf50k"], kept13,
                              kept19["zipf_out"], tmp20, held, keep=kept20)
    finally:
        shutil.rmtree(tmp13, ignore_errors=True)
    gang = kept20["cluster"]
    atexit.register(gang.shutdown)
    del kept13, kept19, kept20
    for label, line in twenty.items():
        emit({"phase20": label, **line, "card": card})
    emit({"phase": "stream_gang", "worker_launches": runs["stream_gang"][0],
          "max_abs_err": runs["stream_gang"][1],
          "seconds": time.perf_counter() - t20, "card": card})

    # phase 21: multi-axis meshes and hierarchical group aggregation, in
    # process and on a gang whose mesh is (dcn, dp); the workers' logs
    # under --out, deleted at the end
    torch.cuda.empty_cache()
    before = set(runs)
    t21 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase21-", dir=a.out)
    try:
        twentyone = phase21_runs(port, hk, gbr_data, variants, flat_outs,
                                 wc, corpora["zipf50k"],
                                 wc_counts["zipf50k"], held, tmp,
                                 cluster=gang)
    finally:
        gang.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(tmp20, ignore_errors=True)
    for label, line in twentyone.items():
        emit({"phase21": label, **line, "card": card})
    new = set(runs) - before
    launches21 = {k: sum(runs[r][0][k] for r in new) for k in TPU_KERNEL}
    unheld = set(TPU_KERNEL) - {k for r in new for k in runs[r][1]}
    if unheld or not all(launches21.values()):
        raise AssertionError(f"phase 21: launches {launches21}, no call of "
                             f"{sorted(unheld)} held")
    emit({"phase": "mesh", "launches": launches21,
          "seconds": time.perf_counter() - t21, "card": card})

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
    for label, prof in (("zipf50k", wc_prof), ("app10k", gbr_prof)):
        emit({"pack_side": label,
                          **pack_side(prof, timed_calls[label]),
                          "card": card})
    for label, pwork, prof in (
            ("zipf50k", path_work(timed_calls["zipf50k"]), wc_prof),
            ("app10k", path_work(timed_calls["app10k"]), gbr_prof)):
        emit({"path_bound": label, "kernels": path_bound(pwork, prof),
              "card": card})
    emit({"phase": "held", "ok": True, "runs": {
        r: {k: {"launches": l[k], "max_abs_err": e[k]} for k in e}
        for r, (l, e) in runs.items()}, "card": card})
    rows = time_kernels(hk, runs, {
        "zipf50k": (timed_calls["zipf50k"], wc_prof),
        "app10k": (timed_calls["app10k"], gbr_prof)}, card)
    rows.append(time_hash_keys(hashing, runs, app_hashes, gbr_prof, card))
    scans["restore"]()
    rows.append(time_seg_scan(hk, runs, scans["dropped"], card))
    del app_hashes
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
