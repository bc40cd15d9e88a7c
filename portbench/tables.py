"""Tables on the device, made from a seed, in the port's partitioned layout.

A generated table is a dict ``{"columns": {name: column}, "counts": [P]
int32, "rows": n}``.  A column is a ``[P, cap]`` (or ``[P, cap, ...]``)
tensor, or a ``(data [P, cap, L] uint8, lengths [P, cap] int32)`` pair for
a string column.  Rows are block-partitioned in generation order: rows
``[p * cap, (p + 1) * cap)`` are partition ``p``, and the last partition's
tail is padding.  This is the layout ``Context.from_pdata`` takes, and the
plain references read the same tensors.

Every column has a ``torch.Generator`` of its own, seeded from the run's
seed and the column's name, so a column's values do not depend on which
other columns a cell asks for.
"""

from __future__ import annotations

import hashlib

import torch


def column_generator(seed: int, name: str, device) -> torch.Generator:
    """A generator on ``device`` whose stream depends on ``seed`` (any
    non-negative integer, 64 bits and wider too) and ``name`` alone."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def randint(seed: int, name: str, low: int, high: int, n: int,
            device) -> torch.Tensor:
    """``n`` int64 integers uniform in [low, high] (both ends included)."""
    g = column_generator(seed, name, device)
    return torch.randint(low, high + 1, (n,), generator=g, device=device)


def block_capacity(n: int, nparts: int) -> int:
    return max(1, -(-n // nparts))


def block_counts(n: int, nparts: int, device) -> torch.Tensor:
    """Valid rows per partition of ``n`` rows laid out in blocks of
    ``block_capacity``."""
    cap = block_capacity(n, nparts)
    starts = torch.arange(nparts, dtype=torch.int64) * cap
    return (n - starts).clamp(0, cap).to(torch.int32).to(device)


def partitioned(flat: torch.Tensor, nparts: int) -> torch.Tensor:
    """``flat`` ([n, ...]) as ``[P, cap, ...]`` blocks, the tail zero."""
    n = flat.shape[0]
    cap = block_capacity(n, nparts)
    pad = nparts * cap - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,) + flat.shape[1:])])
    return flat.view((nparts, cap) + flat.shape[1:])


def string_codes(codes: torch.Tensor, words, max_len: int, nparts: int):
    """A string column whose row ``i`` is ``words[codes[i]]`` (bytes, at
    most ``max_len`` each), as a ``(data, lengths)`` pair."""
    dev = codes.device
    table = torch.zeros((len(words), max_len), dtype=torch.uint8)
    for i, w in enumerate(words):
        if len(w) > max_len:
            raise ValueError(f"{w!r} is longer than {max_len} bytes")
        table[i, :len(w)] = torch.tensor(list(w), dtype=torch.uint8)
    lens = torch.tensor([len(w) for w in words], dtype=torch.int32)
    idx = codes.long()
    return (partitioned(table.to(dev)[idx], nparts),
            partitioned(lens.to(dev)[idx], nparts))


def make_table(columns: dict, n: int, nparts: int, device) -> dict:
    return {"columns": columns, "counts": block_counts(n, nparts, device),
            "rows": n}


def valid_rows(col: torch.Tensor, counts) -> torch.Tensor:
    """The valid rows of a ``[P, cap, ...]`` column, partition order,
    flattened to ``[n, ...]``."""
    return torch.cat([col[p, :int(c)] for p, c in
                      enumerate(counts.tolist())])
