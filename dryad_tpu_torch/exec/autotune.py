"""Chunk sizing from measured copy and dispatch rates — the port of
``dryad_tpu/exec/autotune.py``.

The streamed path moves every chunk across the host <-> device link and
pays a fixed cost per chunk (dispatch and the read back):

    per-chunk wall  ~=  rows x row_bytes / link_rate  +  dispatch_floor

``pick_chunk_rows`` picks the smallest chunk that amortizes the floor to
at most (1 - target_efficiency) of the chunk's wall; the arithmetic is
the JAX package's, so the same rates give the same rows.
``measured_rates`` measures the two rates once per process and device
with a torch probe: one 4 MB device-to-host copy and one scalar fetch.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch

from dryad_tpu_torch.parallel.mesh import resolve_device

__all__ = ["pick_chunk_rows", "measured_rates"]

_RATES: Dict[str, Tuple[float, float]] = {}  # device -> (bytes/s, floor_s)

_MIN_ROWS = 4096
_MAX_ROWS = 4 << 20
# the JAX package's sort-program size guard (``_VALOPS_MAX_ELEMS`` of
# dryad_tpu/ops/kernels.py): XLA on the TPU unrolls sort networks.  Kept
# so that the same rates size chunks alike in both packages; a compile
# guard of the TPU's to revisit on this card (ROADMAP.md)
_VALOPS_MAX_ELEMS = 48 << 20


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measured_rates(probe_mb: int = 4, device="cuda") -> Tuple[float, float]:
    """(device-to-host bytes/s, per-dispatch floor seconds) on
    ``device``, measured once per process: a ``probe_mb`` MB add read back
    to the host, then one scalar fetch (all dispatch and round trip)."""
    dev = resolve_device(device)
    key = str(dev)
    if key in _RATES:
        return _RATES[key]
    n = probe_mb << 20
    x = torch.zeros(n, dtype=torch.uint8, device=dev)
    # warm (allocator, first copy path)
    (x + 1).cpu()
    _sync(dev)
    t0 = time.perf_counter()
    (x + 2).cpu()
    link_wall = time.perf_counter() - t0
    int((x[:8] + 3).sum())
    t0 = time.perf_counter()
    int((x[:8] + 4).sum())
    floor = time.perf_counter() - t0
    link = n / max(link_wall - floor, 1e-9)
    _RATES[key] = (link, floor)
    return _RATES[key]


def pick_chunk_rows(row_bytes: int, config=None,
                    rates: Optional[Tuple[float, float]] = None,
                    target_efficiency: float = 0.85,
                    row_lanes: Optional[int] = None,
                    device="cuda") -> int:
    """Smallest chunk_rows that keeps the dispatch floor amortized to
    <= (1 - target_efficiency) of the per-chunk wall, clamped to
    [4096, 4M] and to the sort-size guard.

    row_bytes: bytes one row moves across the link per cycle (the schema's
    row width); row_lanes: packed 32-bit lanes per row (caps the chunk so
    chunk_rows x lanes stays within ``_VALOPS_MAX_ELEMS``)."""
    link, floor = rates if rates is not None else measured_rates(
        device=device)
    e = min(max(target_efficiency, 0.01), 0.99)
    # floor / (transfer + floor) <= 1-e  =>  transfer >= floor * e/(1-e)
    need_transfer_s = floor * e / (1.0 - e)
    rows = int(need_transfer_s * link / max(row_bytes, 1))
    rows = max(_MIN_ROWS, min(rows, _MAX_ROWS))
    if row_lanes:
        rows = min(rows, max(_MIN_ROWS,
                             _VALOPS_MAX_ELEMS // max(row_lanes, 1) // 4))
    # power-of-two-ish granularity keeps chunk shapes alike across sources
    # of nearby widths
    g = 4096
    return max(g, rows // g * g)
