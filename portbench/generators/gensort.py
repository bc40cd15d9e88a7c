"""Sort Benchmark records on the device, as ``gensort -a`` lays them out,
from a seed.

A record is 100 bytes: a 10-byte key of printable ASCII (each byte
uniform in 0x20 .. 0x7E) and a 90-byte payload: two blanks, the record's
number as 32 upper-case hex digits, two blanks, 52 filler characters (13
hex digits, each written four times), and CR LF.  The payload's number
makes every record distinct, so a sorted output can be checked record by
record against the input.

The table ``records`` has two string columns, ``key`` (max length 10) and
``payload`` (max length 90), in ``tables``' layout.
"""

from __future__ import annotations

import torch

from portbench import tables as T

KEY_LEN, PAYLOAD_LEN = 10, 90
ID_AT, ID_DIGITS = 2, 32          # the record number's hex digits
FILL_AT, FILL_DIGITS = 36, 13     # the filler's digits, four bytes each
CHUNK = 1 << 24                   # records generated per step
_HEX = torch.tensor(list(b"0123456789ABCDEF"), dtype=torch.uint8)


def hex_digits(v: torch.Tensor, digits: int) -> torch.Tensor:
    """[n] int64 -> [n, digits] upper-case hex characters, most
    significant first."""
    shift = 4 * torch.arange(digits - 1, -1, -1, device=v.device)
    nib = (v[:, None] >> shift.clamp(max=60)) & 15
    nib = torch.where(shift[None, :] >= 64, 0, nib)
    return _HEX.to(v.device)[nib]


def make(cfg: dict, reads: dict, seed: int, device) -> dict:
    n, P = cfg["records"], cfg["nparts"]
    cap = T.block_capacity(n, P)
    key = torch.zeros((P * cap, KEY_LEN), dtype=torch.uint8, device=device)
    pay = torch.zeros((P * cap, PAYLOAD_LEN), dtype=torch.uint8,
                      device=device)
    gk = T.column_generator(seed, "key", device)
    gf = T.column_generator(seed, "filler", device)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        m = hi - lo
        key[lo:hi] = torch.randint(0x20, 0x7F, (m, KEY_LEN), generator=gk,
                                   device=device, dtype=torch.uint8)
        ids = torch.arange(lo, hi, device=device, dtype=torch.int64)
        rows = pay[lo:hi]
        rows[:, :ID_AT] = ord(" ")
        rows[:, ID_AT:ID_AT + ID_DIGITS] = hex_digits(ids, ID_DIGITS)
        rows[:, ID_AT + ID_DIGITS:FILL_AT] = ord(" ")
        fill = torch.randint(0, 16, (m, FILL_DIGITS), generator=gf,
                             device=device, dtype=torch.int64)
        rows[:, FILL_AT:FILL_AT + 4 * FILL_DIGITS] = (
            _HEX.to(device)[fill].repeat_interleave(4, dim=1))
        rows[:, PAYLOAD_LEN - 2:] = torch.tensor(list(b"\r\n"),
                                                 dtype=torch.uint8,
                                                 device=device)
    counts = T.block_counts(n, P, device)
    valid = (torch.arange(cap, device=device)[None, :]
             < counts[:, None].long())
    lens = lambda L: torch.where(valid, L, 0).to(torch.int32)  # noqa: E731
    cols = {"key": (key.view(P, cap, KEY_LEN), lens(KEY_LEN)),
            "payload": (pay.view(P, cap, PAYLOAD_LEN), lens(PAYLOAD_LEN))}
    return {"records": {"columns": {c: cols[c] for c in
                                    reads["records"]},
                        "counts": counts, "rows": n}}
