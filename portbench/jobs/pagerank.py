"""Graphalytics PageRank through the port's PageRank app
(``apps/pagerank.pagerank_resident``) over the resident vertex and edge
tables: out-degrees by a group-by count, the edges joined with them and
``cache()``d, ``supersteps`` supersteps under ``Context.do_while`` (a
lookup join with the ranks, the contributions' hash exchange and float32
group sums), and ``collect()`` of every vertex's rank."""

from __future__ import annotations

from portbench import resident

TERMINAL = "collect"


def setup(port, config: dict, tables: dict, device):
    # a port without the app's resident form cannot run this cell: it
    # fails here, before any job
    from dryad_tpu_torch.apps.pagerank import pagerank_resident  # noqa: F401
    ctx = resident.context(port, config, device)
    return ctx, resident.sources(ctx, tables)


def run(ctx, src: dict, params: dict):
    """One job to its terminal: (what every job keeps, the output).  Every
    job keeps its ranks, which the check judges."""
    from dryad_tpu_torch.apps.pagerank import pagerank_resident
    out = pagerank_resident(ctx, src["vertices"], src["edges"],
                            n_iters=params["supersteps"],
                            damping=params["damping"])
    return out, None
