"""Module-level UDFs for the port's cluster tests: a plan callable must
be importable by the workers (``runtime/shiplan.py``), the analogue of
the reference's ``assembly!class.method`` vertex entries
(QueryParser.cs:100).  The workers get this module as ``--fn-module``
(``tests/`` on their PYTHONPATH), so its refs resolve as
``torch_cluster_fns:<name>``; the functions take the port's columns
(torch tensors, ``data.columnar.StringColumn``)."""

import os


def double_v(cols):
    return dict(cols, v=cols["v"] * 2)


def keep_positive(cols):
    return cols["v"] > 0


def poison_wide_lines(cols):
    """Raises for a task whose packed string column is wider than 64
    bytes (``StringColumn.max_len`` is the source's ``str_max_len``), so
    the raise fires identically on the worker and under ``python -m
    dryad_tpu_torch.obs replay`` — the forensics-reproduction fixture."""
    w = cols["line"].max_len
    if w > 64:
        raise ValueError(f"poison partition: line bytes {w} > 64")
    return cols


def no_jax_loaded(cols):
    """Raises in a worker process that has loaded jax or the JAX
    package (``tests/test_torch_isolation.py``)."""
    import sys
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "dryad_tpu"))
    if bad:
        raise RuntimeError(f"worker loaded {bad[:5]}")
    return cols




# -- the gang's tests (tests/test_torch_gang.py) ----------------------------

def inc_v(cols):
    return dict(cols, v=cols["v"] + 1)


def _topsum_seed(cols):
    return cols["v"]


def _topsum_merge(a, b):
    return a + b


def make_sum_dec():
    from dryad_tpu_torch.plan.expr import Decomposable
    return Decomposable(_topsum_seed, _topsum_merge, None)


def second_largest(cols, count):
    """group_apply fn: a group's second largest v (its largest for a
    group of one)."""
    import torch
    v = cols["v"]
    lo = (torch.finfo(v.dtype).min if v.dtype.is_floating_point
          else torch.iinfo(v.dtype).min)
    masked = torch.where(torch.arange(v.shape[0], device=v.device) < count,
                         v, lo)
    s = torch.sort(masked, descending=True).values
    # a one-row group capacity (a streamed run's schema probe) has no s[1]
    second = s[1] if s.shape[0] > 1 else s[0]
    return ({"second": torch.where(count >= 2, second, s[0])[None]},
            torch.ones((1,), dtype=torch.bool, device=v.device))


# registered by name for shipping (shiplan's FN_TABLE path)
SUM_DEC = make_sum_dec()
FN_TABLE = {"sum_dec": SUM_DEC}


# -- the gang phase of chip_smoke.py (PageRank and the skewed join) ----------

# PageRank's node count: the driver sets it for its workers (they inherit
# its environment) when it runs another graph size
PR_NODES = int(os.environ.get("DRYAD_GANG_PR_NODES", "100000"))
PR_DAMPING = 0.85


def pr_contrib(c):
    return {"node": c["dst"], "c": c["rank"] / c["deg"]}


def pr_damp(c):
    return {"node": c["node"],
            "rank": (1.0 - PR_DAMPING) / PR_NODES + PR_DAMPING * c["s"]}


def flag0(c):
    return c["flag"] == 0


def rev_by_custkey(c):
    return {"custkey": c["custkey"], "rev": c["price"] * c["qty"]}


# -- the streamed gang's tests (tests/test_torch_stream_cluster.py) ----------

def zip_x(c):
    return {"x": c["v"]}


def zip_y(c):
    return {"y": c["v"] * 2}


def die_once(c):
    """Kills the worker of process id 1 the first time it runs (the
    marker file ``DRYAD_TEST_DIE_MARKER`` does not exist yet): a
    deterministic worker death in the middle of a streamed job's waves.
    Any later call passes the rows through."""
    marker = os.environ.get("DRYAD_TEST_DIE_MARKER")
    if (marker and os.environ.get("DRYAD_WORKER_ID") == "1"
            and not os.path.exists(marker)):
        open(marker, "w").close()
        os._exit(17)
    return c


# -- the streamed gang phase of chip_smoke.py (gang_stream_q13_1m5) ----------

def q13_hit(c):
    """The orders' columns plus ``hit`` = 1: summed per customer it counts
    the customer's orders (0 for a customer no order matched, whose row a
    right or full join synthesizes)."""
    import torch
    return dict(c, hit=torch.ones_like(c["okey"]))


def q13_okey(c):
    return {"okey": c["okey"]}


def q13_cust(c):
    return {"ck": c["custkey"]}


# -- the SSH backend's tests (tests/test_torch_ssh_cluster.py) ---------------

def in_staged_copy(c):
    """Raises in a worker whose ``dryad_tpu_torch`` is not the copy under
    the first entry of its PYTHONPATH (the staged root, or the first of
    ``remote_pythonpath`` when nothing is staged)."""
    import dryad_tpu_torch
    root = os.environ.get("PYTHONPATH", "").split(os.pathsep)[0]
    here = os.path.abspath(dryad_tpu_torch.__file__)
    if not root or not here.startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"worker imported {here}, not the copy staged "
                           f"under {root!r}")
    return c
