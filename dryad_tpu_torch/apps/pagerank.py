"""PageRank (10 iterations) — BASELINE.md config 4, on the PyTorch port.

Each superstep joins the cached edges-with-out-degree table with the rank
table on ``src = node`` (the rank table is unique-keyed: the lookup
join), turns each edge into a contribution ``rank / deg`` to its ``dst``,
sums the contributions per node with a hash group-by and applies the
damping, under ``Context.do_while``: the body is planned once over a
placeholder and every iteration runs the same stages.  Same signatures
and data as ``dryad_tpu/apps/pagerank.py``; its out-of-core form
(``pagerank_stream``) is not ported yet (ROADMAP.md)."""

from __future__ import annotations

import numpy as np

from dryad_tpu_torch.api.dataset import Context, Dataset

__all__ = ["gen_graph", "pagerank", "pagerank_numpy"]


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
    deg = edges_ds.group_by(["src"], {"deg": ("count", None)})
    # edges joined with their out-degree ONCE, kept on the card: without
    # cache() every superstep would run this join again
    edges_deg = edges_ds.join(deg, ["src"], ["src"], expansion=2.0,
                              right_unique=True).cache()

    nodes = {"node": np.arange(n_nodes, dtype=np.int32),
             "rank": np.full(n_nodes, 1.0 / n_nodes, np.float32)}
    ranks0 = ctx.from_columns(nodes)
    # per-partition capacity of the hash-placed rank table: hash placement
    # is binomial, not exactly even, so leave generous slack
    rank_cap = min(n_nodes, 4 * (-(-n_nodes // ctx.nparts)) + 8)

    def body(ranks: Dataset) -> Dataset:
        contribs = edges_deg.join(ranks, ["src"], ["node"], expansion=2.0,
                                  right_unique=True)
        sums = (contribs
                .select(lambda c: {"node": c["dst"],
                                   "c": c["rank"] / c["deg"]})
                .group_by(["node"], {"s": ("sum", "c")}))
        new_ranks = sums.select(
            lambda c: {"node": c["node"],
                       "rank": (1.0 - damping) / n_nodes + damping * c["s"]})
        return new_ranks.with_capacity(rank_cap)

    out = ctx.do_while(ranks0.with_capacity(rank_cap), body, n_iters=n_iters)
    return out.collect()


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
