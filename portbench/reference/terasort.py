"""The plain reference of TeraSort (``jobs/terasort.py``), in plain
PyTorch, and the comparison that decides ``correct``.

The reference orders the generated records by their whole 10-byte key
with two stable sorts over two lanes (bytes 0-7 as one big-endian
integer, then bytes 8-9).  A sorted output is judged in two ways: its key
at every position against the reference's, and every record against the
input record that its payload's number names, each number once.  Records
with equal keys may come in any order.

The control sorts by the key's first 4 bytes alone: the one-lane sort a
port might be tempted to take, which ties keys that differ further on.
"""

from __future__ import annotations

import torch

from portbench.generators.gensort import ID_AT, ID_DIGITS

# every number compared, with its limit: a sort is exact
LIMITS = {"sort_rows_lost": 0, "sort_keys_misplaced": 0,
          "sort_records_wrong": 0}


def _flat(col, n: int) -> torch.Tensor:
    """The first ``n`` rows of a block-laid-out column (the generated
    tables pad only the last partition's tail)."""
    return col.reshape((-1,) + tuple(col.shape[2:]))[:n]


def _lane(key: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Bytes [lo, hi) of each key as one big-endian int64 (hi - lo <= 7,
    or 8 for printable keys, whose top bit is clear)."""
    out = torch.zeros(key.shape[0], dtype=torch.int64, device=key.device)
    for j in range(lo, hi):
        out = (out << 8) | key[:, j].long()
    return out


def order(key: torch.Tensor, key_bytes: int = 10) -> torch.Tensor:
    """The stable order of ``key`` ([n, 10] uint8) by its first
    ``key_bytes`` bytes."""
    idx = torch.arange(key.shape[0], device=key.device)
    for lo, hi in reversed([(a, min(a + 8, key_bytes))
                            for a in range(0, key_bytes, 8)]):
        o = torch.sort(_lane(key[idx], lo, hi), stable=True).indices
        idx = idx[o]
    return idx


def reference(tables: dict, params: dict, key_bytes: int = 10) -> dict:
    rec = tables["records"]
    n = rec["rows"]
    key = _flat(rec["columns"]["key"][0], n)
    return {"keys": key[order(key, key_bytes)], "rows": n}


def record_ids(payload: torch.Tensor) -> torch.Tensor:
    """The record number written in each payload, or -1 where its digits
    are not upper-case hex."""
    d = payload[:, ID_AT:ID_AT + ID_DIGITS].long()
    val = torch.where(d >= ord("A"), d - ord("A") + 10, d - ord("0"))
    ok = ((val >= 0) & (val < 16)).all(1) & (val[:, :-8] == 0).all(1)
    ids = torch.zeros(d.shape[0], dtype=torch.int64, device=d.device)
    for j in range(ID_DIGITS - 8, ID_DIGITS):
        ids = (ids << 4) | val[:, j].clamp(0, 15)
    return torch.where(ok, ids, -1)


def compare(out: dict, tables: dict, want: dict, counts_each=()) -> dict:
    """The numbers compared.  ``out`` is the program's output in
    ``tables``' layout (``{"columns", "counts"}``); ``counts_each`` the
    partition counts of every job of the window."""
    rec = tables["records"]
    n = want["rows"]
    in_key = _flat(rec["columns"]["key"][0], n)
    in_pay = _flat(rec["columns"]["payload"][0], n)
    (kd, kl), (pd, pl) = out["columns"]["key"], out["columns"]["payload"]
    counts = [int(c) for c in out["counts"].tolist()]
    lost = max([abs(n - int(sum(c))) for c in counts_each]
               + [abs(n - sum(counts))])
    misplaced = wrong = 0
    seen = torch.zeros(n, dtype=torch.int64, device=in_key.device)
    at = 0
    for p, c in enumerate(counts):
        c = min(c, max(n - at, 0))
        if not c:
            continue
        key, pay = kd[p, :c], pd[p, :c]
        klen, plen = kl[p, :c], pl[p, :c]
        ref = want["keys"][at:at + c]
        misplaced += int(((key != ref).any(1) | (klen != ref.shape[1])
                          ).sum())
        ids = record_ids(pay)
        good = ids >= 0
        src = ids.clamp(0, n - 1)
        same = ((key == in_key[src]).all(1) & (pay == in_pay[src]).all(1)
                & (klen == key.shape[1]) & (plen == pay.shape[1]))
        wrong += int((~(good & same)).sum())
        seen.index_add_(0, src[good], torch.ones_like(src[good]))
        at += c
    # a record missing or repeated is wrong too
    wrong += int((seen != 1).sum())
    return {"sort_rows_lost": lost, "sort_keys_misplaced": misplaced,
            "sort_records_wrong": wrong}


def check(tables: dict, params: dict, jobs: list, last) -> tuple:
    """The window against the reference: every job's partition counts
    (each job keeps them), the last job's output record by record.
    Returns the numbers and the number of jobs that failed."""
    want = reference(tables, params)
    counts_each = [[int(c) for c in j["keep"].tolist()] for j in jobs]
    nums = compare(last, tables, want, counts_each)
    failed = sum(abs(want["rows"] - sum(c)) > 0 for c in counts_each)
    failed = max(failed, int(any(nums[k] > LIMITS[k] for k in nums)))
    return nums, failed


def control(tables: dict, params: dict) -> dict:
    """The control's numbers: its output against the reference."""
    return compare(control_output(tables, params), tables,
                   reference(tables, params))


def control_output(tables: dict, params: dict) -> dict:
    """The control's output, in the program's place: the records ordered
    by their first 4 key bytes, as one partition."""
    rec = tables["records"]
    n = rec["rows"]
    key = _flat(rec["columns"]["key"][0], n)
    pay = _flat(rec["columns"]["payload"][0], n)
    o = order(key, key_bytes=4)
    full = lambda t: torch.full((1, n), t.shape[1], dtype=torch.int32,
                                device=t.device)  # noqa: E731
    k, p = key[o][None], pay[o][None]
    return {"columns": {"key": (k, full(key)), "payload": (p, full(pay))},
            "counts": torch.tensor([n], dtype=torch.int32)}
