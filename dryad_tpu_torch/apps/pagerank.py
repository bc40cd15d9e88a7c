"""PageRank (10 iterations) — BASELINE.md config 4, on the PyTorch port.

Each superstep joins the cached edges-with-out-degree table with the rank
table on ``src = node`` (the rank table is unique-keyed: the lookup
join), turns each edge into a contribution ``rank / deg`` to its ``dst``,
sums the contributions per node with a hash group-by and applies the
damping, under ``Context.do_while``: the body is planned once over a
placeholder and every iteration runs the same stages.  Same signatures
and data as ``dryad_tpu/apps/pagerank.py``.  ``pagerank_resident`` runs
the same supersteps over vertex and edge tables already on the device
(sparse ids, |V| counted from the vertex table).  ``pagerank_stream`` is the
out-of-core form: the edges stream (a streamed Dataset, ``.cache()``-d
to re-stream a local chunk cache) and the rank table iterates as a
small host table through the streamed ``do_while``."""

from __future__ import annotations

import numpy as np
import torch

from dryad_tpu_torch.api.dataset import Context, Dataset

__all__ = ["gen_graph", "pagerank", "pagerank_resident", "pagerank_stream",
           "pagerank_numpy"]


def gen_graph(n_nodes: int, n_edges: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    src = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    # every node gets one outgoing edge on a ring (no dangling nodes), so
    # the simple update rule is exact
    src = np.concatenate([src, np.arange(n_nodes, dtype=np.int32)])
    dst = np.concatenate([dst, ((np.arange(n_nodes) + 1) % n_nodes)
                          .astype(np.int32)])
    return {"src": src, "dst": dst}


def pagerank(ctx: Context, edges: dict, n_nodes: int, n_iters: int = 10,
             damping: float = 0.85) -> dict:
    edges_ds = ctx.from_columns(edges)
    nodes = {"node": np.arange(n_nodes, dtype=np.int32),
             "rank": np.full(n_nodes, 1.0 / n_nodes, np.float32)}
    return _supersteps(ctx, edges_ds, ctx.from_columns(nodes), n_nodes,
                       n_iters, damping).collect()


def pagerank_resident(ctx: Context, vertices: Dataset, edges: Dataset,
                      n_iters: int = 10, damping: float = 0.85) -> dict:
    """PageRank over tables already on the device: ``vertices`` (column
    ``id``, sparse int32 ids) and ``edges`` (``src``, ``dst``, both
    directions of an undirected edge present), with |V| the vertex
    table's rows.  Every vertex needs an in-edge (no dangling vertex, as
    in an undirected graph without isolated vertices), or it drops out of
    the ranks.  Returns ``{"id", "rank"}`` (float32).

    Both lookup joins size their output to what a unique right side can
    produce, one row per left row: at ``expansion=2.0`` a graph of 128M
    edge rows carried 64M-row capacities a partition into every
    superstep's group-by and ran an 80 GB card out of memory."""
    n = vertices.count()
    ranks0 = vertices.select(
        lambda c: {"node": c["id"], "rank": torch.full_like(
            c["id"], 1.0 / n, dtype=torch.float32)})
    out = _supersteps(ctx, edges, ranks0, n, n_iters, damping,
                      expansion=1.0).collect()
    return {"id": out["node"], "rank": out["rank"]}


def _supersteps(ctx: Context, edges_ds: Dataset, ranks0: Dataset,
                n_nodes: int, n_iters: int, damping: float,
                expansion: float = 2.0) -> Dataset:
    """The ranks after ``n_iters`` supersteps from ``ranks0`` (``node``,
    ``rank``) over the edges (``src``, ``dst``); both lookup joins' output
    capacity is ``expansion`` x their left side's."""
    deg = edges_ds.group_by(["src"], {"deg": ("count", None)})
    # edges joined with their out-degree ONCE, kept on the card: without
    # cache() every superstep would run this join again
    edges_deg = edges_ds.join(deg, ["src"], ["src"], expansion=expansion,
                              right_unique=True).cache()
    # per-partition capacity of the hash-placed rank table: hash placement
    # is binomial, not exactly even, so leave generous slack
    rank_cap = min(n_nodes, 4 * (-(-n_nodes // ctx.nparts)) + 8)

    def body(ranks: Dataset) -> Dataset:
        contribs = edges_deg.join(ranks, ["src"], ["node"],
                                  expansion=expansion, right_unique=True)
        sums = (contribs
                .select(lambda c: {"node": c["dst"],
                                   "c": c["rank"] / c["deg"]})
                .group_by(["node"], {"s": ("sum", "c")}))
        new_ranks = sums.select(
            lambda c: {"node": c["node"],
                       "rank": (1.0 - damping) / n_nodes + damping * c["s"]})
        return new_ranks.with_capacity(rank_cap)

    return ctx.do_while(ranks0.with_capacity(rank_cap), body,
                        n_iters=n_iters)


def pagerank_stream(ctx: Context, edges_ds: Dataset, n_nodes: int,
                    n_iters: int = 10, damping: float = 0.85) -> dict:
    """PageRank over streamed edges: ``edges_ds`` is a STREAMED dataset
    (``ctx.read_store_stream(path)``, ``.cache()``-d so that supersteps
    re-stream the local chunk cache).  The out-degrees are cached once;
    each superstep streams the edges through two joins (out-degree, then
    rank: both build sides materialized on the device) and a streamed
    group-by.  The device holds O(chunk_rows) rows whatever the edge
    count."""
    deg = edges_ds.group_by(["src"], {"deg": ("count", None)}).cache()

    nodes = {"node": np.arange(n_nodes, dtype=np.int32),
             "rank": np.full(n_nodes, 1.0 / n_nodes, np.float32)}
    ranks0 = ctx.from_columns(nodes)

    def contrib(c):
        return {"node": c["dst"], "c": c["rank"] / c["deg"]}

    def damp(c):
        return {"node": c["node"],
                "rank": (1.0 - damping) / n_nodes + damping * c["s"]}

    def body(ranks: Dataset) -> Dataset:
        return (edges_ds
                .join(deg, ["src"], ["src"], expansion=2.0)
                .join(ranks, ["src"], ["node"], expansion=2.0)
                .select(contrib)
                .group_by(["node"], {"s": ("sum", "c")})
                .select(damp))

    return ctx.do_while(ranks0, body, n_iters=n_iters).collect()


def pagerank_numpy(edges: dict, n_nodes: int, n_iters: int = 10,
                   damping: float = 0.85):
    """Dense float64 reference."""
    src, dst = edges["src"], edges["dst"]
    deg = np.bincount(src, minlength=n_nodes)
    r = np.full(n_nodes, 1.0 / n_nodes, np.float64)
    for _ in range(n_iters):
        contrib = r[src] / deg[src]
        s = np.zeros(n_nodes, np.float64)
        np.add.at(s, dst, contrib)
        r = (1 - damping) / n_nodes + damping * s
    return r
