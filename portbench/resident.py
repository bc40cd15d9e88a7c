"""Jobs over tables resident on one card: the port's in-process
``Context`` and a ``Dataset`` over each generated table, with no copy.
A job module whose cell runs elsewhere (worker processes, a gang)
builds its context by other means."""

from __future__ import annotations


def context(port, config: dict, device):
    """The port's in-process context: ``config["nparts"]`` logical
    partitions on ``device``."""
    return port.Context(device=str(device), nparts=config.get("nparts", 8))


def sources(ctx, tables: dict) -> dict:
    """A Dataset over each resident table (no copy)."""
    from dryad_tpu_torch.data.columnar import Batch, StringColumn
    from dryad_tpu_torch.exec.data import PData
    out = {}
    for name, t in tables.items():
        cols = {k: StringColumn(*v) if isinstance(v, tuple) else v
                for k, v in t["columns"].items()}
        out[name] = ctx.from_pdata(PData(Batch(cols, t["counts"]),
                                         len(t["counts"])))
    return out


def as_table(pd) -> dict:
    """A PData in the generated tables' layout."""
    cols = {k: (v.data, v.lengths) if hasattr(v, "lengths") else v
            for k, v in pd.batch.columns.items()}
    return {"columns": cols, "counts": pd.batch.count}
