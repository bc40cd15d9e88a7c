"""The cases of the gang rehearsal (``tests/test_torch_gang_exchange.py``):
each one runs on a ``parallel.mesh.Mesh`` and returns, per partition the
mesh holds, its rows in order, plus the NEEDs, slots, bounds and stage
logs as the gang's all-reduce (max) sees them.  The parent runs them on
a one-process P = 8 mesh; ``rank_main`` runs them in each of four gloo
processes holding two partitions each.  No jax here: the rank processes
stay light."""

import dataclasses
import os
import pickle
import types

import numpy as np
import torch

from dryad_tpu_torch.exec.data import (pdata_from_host, pdata_to_numpy,
                                       split_partitions, stack_partitions)
from dryad_tpu_torch.exec.executor import Executor
from dryad_tpu_torch.parallel import shuffle
from dryad_tpu_torch.parallel.mesh import STAGED, Mesh

P = 8
WORLD = 4
N = 1_200
WORDS = [b"w%03d" % i for i in range(97)]

LOG_KEYS = ("stage", "label", "exchange", "exchanges", "broadcasts",
            "attempts", "scale", "slack", "salted", "salted_attempts",
            "slot_rows", "slot_source", "probes", "recv_rows",
            "settle_replayed")


def data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(-500, 500, n).astype(np.int32),
            "s": [WORDS[i] for i in rng.integers(0, len(WORDS), n)],
            "v": rng.standard_normal(n).astype(np.float32),
            "i": np.arange(n, dtype=np.int32)}


def skewed(seed=1, n=N, hot=0.9):
    rng = np.random.default_rng(seed)
    k = rng.integers(1, 400, n).astype(np.int32)
    k[rng.random(n) < hot] = 0
    return {"k": k, "i": np.arange(n, dtype=np.int32)}


def _rows_of(pd):
    """Each partition's valid rows, in order, as tuples of bytes."""
    cols, counts = pdata_to_numpy(pd)
    out = []
    for p in range(len(counts)):
        n = int(counts[p])
        rows = []
        for i in range(n):
            row = []
            for k in sorted(cols):
                v = cols[k]
                if isinstance(v, tuple) and v[1].ndim == 2:
                    row.append(bytes(v[0][p, i, :v[1][p, i]]))
                elif isinstance(v, tuple):   # a window of strings
                    row.append(v[0][p, i].tobytes() + v[1][p, i].tobytes())
                else:
                    row.append(v[p, i].tobytes())
            rows.append(tuple(row))
        out.append(rows)
    return out


def _max(mesh, *ts):
    """The gang's max of each 0-d tensor (the executor's all-reduce)."""
    t = torch.stack([torch.as_tensor(x).to(torch.int64).reshape(())
                     for x in ts])
    return mesh.all_reduce_max(t).tolist()


def _ctx(mesh):
    """A Context whose executor and sources run on ``mesh``."""
    from dryad_tpu_torch import Context
    ctx = Context(device="cpu", nparts=mesh.nparts, install_trace=False)
    ctx.mesh = mesh
    ctx.executor = Executor(mesh, config=ctx.config)
    return ctx


def _mark_part(b, idx):
    return b.with_columns({"part": torch.full((b.capacity,), idx,
                                              dtype=torch.int32)})


def _k_small(cols):
    return cols["k"] < 300


def _exchange_cases(mesh):
    out = {}
    pd = pdata_from_host(data(), mesh, str_max_len=8)
    parts = split_partitions(pd)
    cap = pd.capacity
    for name, keys, out_cap, slot in (
            ("hash_k", ["k"], 2 * cap, None),
            ("hash_s", ["s"], 2 * cap, None),
            ("hash_sk", ["s", "k"], 2 * cap, None),
            # a receive shortfall and a measured slot that falls short
            ("hash_needs", ["k"], cap // 2, 4)):
        got, nr, nsl, su = shuffle.hash_exchange(
            parts, keys, out_cap, slot_rows=slot, mesh=mesh)
        out[name] = {"parts": _rows_of(stack_partitions(got)),
                     "needs": _max(mesh, nr, nsl, su)}
    # the hierarchical aggregation's hops on the (dcn, dp) mesh (the
    # gang's default axes; one process takes them explicitly): each
    # hop's rows, NEEDs and the collectives it staged itself
    m2 = mesh if mesh.gang else dataclasses.replace(
        mesh, axes=(("dcn", WORLD), ("dp", P // WORLD)))
    for axis in ("dp", "dcn"):
        before = dict(STAGED)
        got, nr, nsl, su = shuffle.hash_exchange(
            parts, ["k"], 2 * cap, mesh=m2, axis=axis)
        staged = {k: STAGED[k] - before[k] for k in ("collectives", "bytes")}
        out[f"axis_{axis}"] = {"parts": _rows_of(stack_partitions(got)),
                               "needs": _max(mesh, nr, nsl, su),
                               "staged": staged}
    ex = Executor(mesh)
    bounds = ex._range_bounds(pd, "k")
    got, nr, nsl, su = shuffle.range_exchange(parts, "k", bounds, 2 * cap,
                                              mesh=mesh)
    out["range_k"] = {"parts": _rows_of(stack_partitions(got)),
                      "needs": _max(mesh, nr, nsl, su),
                      "bounds": bounds.tolist()}
    sbounds = ex._range_bounds(pd, "s")
    got, nr, nsl, su = shuffle.range_exchange(parts, "s", sbounds, 2 * cap,
                                              descending=True, mesh=mesh)
    out["range_s_desc"] = {"parts": _rows_of(stack_partitions(got)),
                           "needs": _max(mesh, nr, nsl, su),
                           "bounds": sbounds.tolist()}
    for name, out_cap in (("broadcast", N), ("broadcast_short", N // 3)):
        small = [b.with_count(torch.clamp(b.count, max=40 + 3 * q))
                 for q, b in enumerate(parts, mesh.part_start)]
        got, nr, nsl = shuffle.broadcast_gather(small, out_cap, mesh)
        out[name] = {"parts": _rows_of(stack_partitions(got)),
                     "needs": _max(mesh, nr, nsl)}
    # zip: the right side shorter and blocked differently
    right = pdata_from_host({"x": np.arange(N - 77, dtype=np.int32) * 3},
                            mesh, capacity=cap)
    rparts = [b.with_count(torch.clamp(b.count - 5 * (q % 3), min=0))
              for q, b in enumerate(split_partitions(right),
                                    mesh.part_start)]
    got, nr, nsl = shuffle.zip_exchange(parts, rparts, mesh=mesh)
    out["zip"] = {"parts": _rows_of(stack_partitions(got)),
                  "needs": _max(mesh, nr, nsl)}
    # the salted join exchange over a 90 %-hot left side
    lpd = pdata_from_host(skewed(), mesh)
    rpd = pdata_from_host({"k": np.arange(400, dtype=np.int32),
                           "w": np.arange(400, dtype=np.int32) * 7}, mesh)
    lo, ro, lnr, rnr, nsl = shuffle.skew_join_exchange(
        split_partitions(lpd), split_partitions(rpd), ["k"], ["k"],
        2 * lpd.capacity, 2 * rpd.capacity, topk=4, send_slack=P,
        mesh=mesh)
    out["salted"] = {"parts": _rows_of(stack_partitions(lo))
                     + _rows_of(stack_partitions(ro)),
                     "needs": _max(mesh, lnr, rnr, nsl)}
    run = types.SimpleNamespace(probes_run=0, host_reads=0)
    out["probe"] = {"parts": [[] for _ in range(mesh.local_nparts)],
                    "needs": [ex._probe_slot_rows(pd, ["k"], 2, run),
                              ex._probe_slot_rows(lpd, ["k"], 2, run)]}
    return out


def _query_cases(mesh):
    out = {}
    queries = {
        "q_hash": lambda d: d.hash_partition(["k"]),
        "q_range": lambda d: d.range_partition(["k"]),
        "q_take": lambda d: d.take(37),
        "q_skip": lambda d: d.skip(530),
        "q_row_index": lambda d: d.where(_k_small).with_row_index("r"),
        "q_take_while": lambda d: d.take_while(_k_small),
        "q_skip_while": lambda d: d.skip_while(_k_small),
        "q_window": lambda d: d.sliding_window(4),
        "q_part_index": lambda d: d.apply_with_partition_index(_mark_part),
        "q_hash_part_index": lambda d: d.hash_partition(
            ["k"]).apply_with_partition_index(_mark_part),
        "q_group_order": lambda d: d.group_by(
            ["s"], {"n": ("count", None), "m": ("max", "k")}).order_by(
            [("n", True), ("s", False)]),
    }
    for name, q in queries.items():
        ctx = _ctx(mesh)
        src = ctx.from_columns(data(), str_max_len=8)
        pd = q(src)._materialize()
        out[name] = {"parts": _rows_of(pd),
                     "log": [{k: e[k] for k in LOG_KEYS}
                             for e in ctx.executor.stage_log],
                     "needs": [ctx.executor.host_reads]}
    # the skewed join, salted at attempt 2, through the executor
    ctx = _ctx(mesh)
    sk = skewed(hot=0.95, n=4_000)
    left = ctx.from_columns(sk)
    right = ctx.from_columns({"k": np.arange(400, dtype=np.int32),
                              "w": np.arange(400, dtype=np.int32) * 7})
    pd = left.join(right, ["k"], ["k"])._materialize()
    out["q_salted_join"] = {
        "parts": _rows_of(pd),
        "log": [{k: e[k] for k in LOG_KEYS}
                for e in ctx.executor.stage_log],
        "needs": [ctx.executor.host_reads]}
    return out


def run_cases(mesh):
    torch.manual_seed(0)
    out = _exchange_cases(mesh)
    out.update(_query_cases(mesh))
    return out


def rank_main(rank, world, port, out_dir):
    """One gloo process of the rehearsal: its cases' results pickled to
    ``out_dir/rank<r>.pkl``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        res = run_cases(Mesh(torch.device("cpu"), P, rank, world))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
