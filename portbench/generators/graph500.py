"""A Graph500 Kronecker graph on the device, made from a seed by the rules
of the Graph500 specification (section 3, the edge generator), as LDBC
Graphalytics' ``graph500-<scale>`` datasets are made from it.

* ``edgefactor << scale`` edges, made in chunks of ``CHUNK`` edges.  Each
  edge sets its endpoints' bits one level at a time: at each of the
  ``scale`` levels one uniform draw picks a quadrant of the adjacency
  matrix with the initiator's probabilities A, B, C, D, in that order
  (0, 0), (0, 1), (1, 0), (1, 1): the first bit goes to the source, the
  second to the destination.
* The vertex labels are permuted by the seed.
* Graphalytics' undirected form: self-loops are dropped, and repeated
  edges are removed by sorting the ``(min, max)`` pairs of the
  endpoints; each remaining edge is emitted in both directions.  The
  vertices are the ids that kept an edge (degree >= 1), in id order.
* The directed edge rows are shuffled by the seed and block-partitioned
  over ``nparts`` partitions.

Tables: ``vertices`` (``id``, int32) and ``edges`` (``src``, ``dst``,
int32).  Each step has a ``torch.Generator`` of its own (``tables.py``),
so the counts match Graphalytics' only to within sampling.
"""

from __future__ import annotations

import torch

from portbench import tables as T

CHUNK = 1 << 24     # edges drawn at once: a chunk's draws take 128 MiB


def quadrant_bits(u: torch.Tensor, initiator) -> tuple:
    """(source bit, destination bit) of each uniform draw ``u``, the
    quadrant it picks with probabilities A, B, C, D."""
    a, b, c, _d = (float(p) for p in initiator)
    q = (u >= a).long() + (u >= a + b).long() + (u >= a + b + c).long()
    return q >> 1, q & 1


def kronecker(cfg: dict, seed: int, device) -> tuple:
    """The generated edge list ``(src, dst)`` (int64, before the labels
    are permuted), self-loops and repeats still in."""
    scale, n = cfg["scale"], cfg["edgefactor"] << cfg["scale"]
    g = T.column_generator(seed, "kronecker", device)
    src = torch.empty(n, dtype=torch.int64, device=device)
    dst = torch.empty(n, dtype=torch.int64, device=device)
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        s = torch.zeros(m, dtype=torch.int64, device=device)
        d = torch.zeros(m, dtype=torch.int64, device=device)
        for level in range(scale):
            u = torch.rand(m, generator=g, dtype=torch.float64,
                           device=device)
            sb, db = quadrant_bits(u, cfg["initiator"])
            s |= sb << level
            d |= db << level
        src[lo:lo + m], dst[lo:lo + m] = s, d
    return src, dst


def permuted(src: torch.Tensor, dst: torch.Tensor, scale: int, seed: int
             ) -> tuple:
    """The edge list with the vertex labels permuted by the seed."""
    perm = torch.randperm(1 << scale, generator=T.column_generator(
        seed, "labels", src.device), device=src.device)
    return perm[src], perm[dst]


def undirected(src: torch.Tensor, dst: torch.Tensor, scale: int) -> tuple:
    """The distinct undirected edges ``(lo, hi)``, lo < hi, in key order:
    self-loops dropped, repeats removed."""
    keep = src != dst
    lo = torch.minimum(src, dst)[keep]
    hi = torch.maximum(src, dst)[keep]
    key = torch.unique(lo << scale | hi)
    return key >> scale, key & ((1 << scale) - 1)


def graph(cfg: dict, seed: int, device) -> dict:
    """``{"id": vertices, "src": ..., "dst": ...}``: the vertex ids of
    degree >= 1 in id order and the shuffled directed edge rows, int32,
    on ``device``."""
    scale = cfg["scale"]
    lo, hi = undirected(*permuted(*kronecker(cfg, seed, device), scale,
                                  seed), scale)
    deg = torch.bincount(torch.cat([lo, hi]), minlength=1 << scale)
    ids = torch.nonzero(deg > 0).flatten().to(torch.int32)
    lo, hi = lo.to(torch.int32), hi.to(torch.int32)
    del deg
    order = torch.randperm(2 * lo.numel(), generator=T.column_generator(
        seed, "edge_order", device), device=device)
    src = torch.cat([lo, hi])[order]
    dst = torch.cat([hi, lo])[order]
    return {"id": ids, "src": src, "dst": dst}


TABLES = {"vertices": ("id",), "edges": ("src", "dst")}


def make(cfg: dict, reads: dict, seed: int, device) -> dict:
    """The tables ``reads`` names, each with the columns it lists, in
    ``tables``' layout over ``cfg["nparts"]`` partitions."""
    cols, P = graph(cfg, seed, device), cfg["nparts"]
    out = {}
    for table, names in reads.items():
        if not set(names) <= set(TABLES[table]):
            raise KeyError(f"{table} has columns {TABLES[table]}, not "
                           f"{names}")
        n = cols[TABLES[table][0]].numel()
        out[table] = T.make_table({c: T.partitioned(cols[c], P)
                                   for c in names}, n, P, device)
    return out
