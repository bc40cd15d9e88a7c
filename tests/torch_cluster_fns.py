"""Module-level UDFs for the port's cluster tests: a plan callable must
be importable by the workers (``runtime/shiplan.py``), the analogue of
the reference's ``assembly!class.method`` vertex entries
(QueryParser.cs:100).  The workers get this module as ``--fn-module``
(``tests/`` on their PYTHONPATH), so its refs resolve as
``torch_cluster_fns:<name>``; the functions take the port's columns
(torch tensors, ``data.columnar.StringColumn``)."""


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


FN_TABLE = {}
