"""The plain reference of Graphalytics PageRank (``jobs/pagerank.py``), in
plain PyTorch, and the comparison that decides ``correct``.

It reads the generated tables (``tables.py``'s layout) and nothing of the
program.  Ranks live in dense float64 arrays over the id space (the
largest id + 1): out-degrees from ``bincount``, each superstep's
contributions gathered by source and added to their destinations with
``index_add_``, and Graphalytics' dangling term computed from the
vertices of out-degree 0:

    PR_0(v) = 1 / |V|
    PR_i(v) = (1 - d) / |V| + d * sum_{u -> v} PR_{i-1}(u) / outdeg(u)
              + d / |V| * sum_{w dangling} PR_{i-1}(w)

The graph is undirected with its isolated vertices dropped, so no vertex
dangles and the dangling mass (``pr_dangling_mass``, summed over the
supersteps) is 0 by construction; it is compared all the same.

Every job of the window is judged: its ``{id, rank}`` answer against the
reference.  ``pr_vertices_gap`` counts ids missing from the answer,
repeated in it, or not in the vertex table.  ``pr_ranks_off`` counts
vertices whose rank is off its reference value by more than ``RTOL`` of
it.  The tolerance: float32 ranks whose group sums are compensated stay
near 1e-6 of the float64 ranks after 10 supersteps; contributions rounded
to bfloat16 (the control) are off by about 4e-3, and an uncompensated
float32 prefix difference loses the ulp of a partition's running total
(about 7e-9) against ranks near 4e-7.  Both fail it.
"""

from __future__ import annotations

import sys

import torch

from portbench import tables as T

# every number compared, with its limit
LIMITS = {"pr_vertices_gap": 0, "pr_ranks_off": 0, "pr_dangling_mass": 0}
RTOL = 1e-4


def _col(table, name):
    return T.valid_rows(table["columns"][name], table["counts"]).long()


def reference(tables: dict, params: dict, contrib=None) -> dict:
    """The float64 ranks over the dense id space, which ids are vertices,
    and the dangling mass.  ``contrib`` (a dtype) rounds each superstep's
    contributions to it: the control."""
    ids = _col(tables["vertices"], "id")
    src, dst = (_col(tables["edges"], c) for c in ("src", "dst"))
    space = int(max(ids.max(), src.max(), dst.max())) + 1
    n, d = ids.numel(), float(params["damping"])
    member = torch.zeros(space, dtype=torch.bool, device=ids.device)
    member[ids] = True
    deg = torch.bincount(src, minlength=space).double()
    dangling = member & (deg == 0)
    inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1), 0.0)
    r = torch.zeros(space, dtype=torch.float64, device=ids.device)
    r[ids] = 1.0 / n
    mass = 0.0
    for _ in range(params["supersteps"]):
        c = r[src] * inv[src]
        if contrib is not None:
            c = c.to(contrib).double()
        s = torch.zeros(space, dtype=torch.float64, device=ids.device)
        s.index_add_(0, dst, c)
        lost = float(r[dangling].sum())
        mass += lost
        r = torch.where(member, (1.0 - d) / n + d * s + d * lost / n, 0.0)
    return {"rank": r, "member": member, "ids": ids, "dangling": mass}


def compare(got: dict, want: dict) -> dict:
    """The numbers compared for one answer ``{id, rank}``, and its largest
    relative rank error (``rel_err``, over the ids it has once)."""
    member, ref = want["member"], want["rank"]
    dev, space = ref.device, ref.numel()
    gid = torch.as_tensor(got["id"]).to(dev).long()
    grank = torch.as_tensor(got["rank"]).to(dev).double()
    inside = (gid >= 0) & (gid < space)
    ok_id = torch.zeros_like(inside)
    ok_id[inside] = member[gid[inside]]
    seen = torch.bincount(gid[ok_id], minlength=space)
    gap = (int((~ok_id).sum()) + int((seen - 1).clamp(min=0).sum())
           + int((member & (seen == 0)).sum()))
    once = ok_id.clone()
    once[ok_id] = seen[gid[ok_id]] == 1
    true = ref[gid[once]]
    err = (grank[once] - true).abs()
    off = ~(err <= RTOL * true)
    rel = float((err / true).max()) if true.numel() else 0.0
    return {"pr_vertices_gap": gap, "pr_ranks_off": int(off.sum()),
            "rel_err": rel}


def check(tables: dict, params: dict, jobs: list, last) -> tuple:
    """Every job of the window against the reference: the worst of each
    number over the jobs, and the number of jobs that failed."""
    want = reference(tables, params)
    worst, failed = {k: 0 for k in LIMITS}, 0
    rel = 0.0
    for j in jobs:
        nums = compare(j["keep"], want)
        nums["pr_dangling_mass"] = want["dangling"]
        failed += any(nums[k] > LIMITS[k] for k in LIMITS)
        worst = {k: max(worst[k], nums[k]) for k in LIMITS}
        rel = max(rel, nums["rel_err"])
    # beside the numbers compared: how near the ranks came
    print(f"pagerank largest relative rank error {rel!r}", file=sys.stderr)
    return worst, failed


def control(tables: dict, params: dict) -> dict:
    """The control's numbers: the reference with each superstep's
    contributions rounded to bfloat16 (the step that would halve the
    exchange's value bytes), its float32 ranks in the program's place."""
    want = reference(tables, params)
    low = reference(tables, params, contrib=torch.bfloat16)
    ids = want["ids"]
    nums = compare({"id": ids, "rank": low["rank"][ids].float()}, want)
    nums["pr_dangling_mass"] = want["dangling"]
    return {k: nums[k] for k in LIMITS}
