"""64-bit hashing of record keys as two 32-bit lanes — bit-exact with
``dryad_tpu/ops/hashing.py``.

The JAX package computes in wrapping ``uint32``.  PyTorch's ``uint32``
lacks most arithmetic, so the port carries every 32-bit lane as
``int64`` holding a value in [0, 2**32): additions and xors are masked
back to 32 bits, right shifts are then logical, and a product with a
32-bit constant is split into 16-bit halves so that no intermediate
leaves int64 (``mul32``).  The results are the JAX package's hashes bit
for bit, which is what makes the exchange destinations ``lo % D`` agree.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from dryad_tpu_torch.data.columnar import Batch, StringColumn

__all__ = ["hash_column", "hash_columns", "hash_batch_keys", "M32", "mul32",
           "to_u32", "from_u32", "canon_zero"]

M32 = 0xFFFFFFFF

_MAX_HASH_LEN = 512
_BYTE_W = None


def _byte_weights() -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic odd weights for the byte dot-product hash — the same
    draw from ``RandomState(0xD47AD)`` as the JAX package."""
    global _BYTE_W
    if _BYTE_W is None:
        rng = np.random.RandomState(0xD47AD)
        _BYTE_W = (rng.randint(0, 2**31, _MAX_HASH_LEN)
                   .astype(np.uint32) * 2 + 1,
                   rng.randint(0, 2**31, _MAX_HASH_LEN)
                   .astype(np.uint32) * 2 + 1)
    return _BYTE_W


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit (or narrower) tensor's bits as an int64 lane in
    [0, 2**32)."""
    if x.dtype == torch.float32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & M32


def from_u32(lane: torch.Tensor) -> torch.Tensor:
    """An int64 lane in [0, 2**32) back to int32 bits."""
    return (lane - ((lane >> 31) << 32)).to(torch.int32)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for a lane x and a 32-bit constant c."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _mix32(x: torch.Tensor, c1: int, c2: int) -> torch.Tensor:
    """xorshift-multiply avalanche (murmur3 finalizer shape)."""
    x = x & M32
    x = x ^ (x >> 16)
    x = mul32(x, c1)
    x = x ^ (x >> 13)
    x = mul32(x, c2)
    x = x ^ (x >> 16)
    return x


def _combine(h, g):
    """Combine two 64-bit lane-pair hashes (boost::hash_combine style)."""
    def one(a, b, c1, c2):
        t = (b + 0x9E3779B9 + ((a << 6) & M32) + (a >> 2)) & M32
        return _mix32(a ^ t, c1, c2)

    return (one(h[0], g[0], 0x85EBCA6B, 0xC2B2AE35),
            one(h[1], g[1], 0xCC9E2D51, 0x1B873593))


def canon_zero(col: torch.Tensor) -> torch.Tensor:
    """Float keys: -0.0 and the subnormals become +0.0.  The JAX
    package's XLA backends flush subnormals to zero, so there a subnormal
    key compares equal to 0 and is canonicalized with it; the port does
    the same explicitly, so the two packages group and route alike."""
    tiny = torch.finfo(col.dtype).tiny
    return torch.where(col.abs() < tiny, torch.zeros_like(col), col)


def _hash_dense(col: torch.Tensor):
    """Hash a dense [n] or [n, k] numeric column to (hi, lo) lanes."""
    if col.dtype.is_floating_point:
        # canonicalize zeros, then hash the f32 bit pattern
        bits = to_u32(canon_zero(col).to(torch.float32))
    elif col.dtype == torch.bool:
        bits = col.to(torch.int64)
    elif col.dtype in (torch.int64, torch.uint64):
        # both 32-bit halves, so values differing only in the high word
        # don't collide
        c = col.to(torch.int64)
        lo32, hi32 = c & M32, (c >> 32) & M32
        bits = torch.stack([hi32, lo32], dim=-1) if col.dim() == 1 else \
            torch.cat([hi32, lo32], dim=-1)
    else:
        bits = col.to(torch.int64) & M32
    if bits.dim() == 1:
        bits = bits[:, None]
    n = bits.shape[0]
    hi = torch.zeros(n, dtype=torch.int64, device=bits.device)
    lo = torch.zeros(n, dtype=torch.int64, device=bits.device)
    for j in range(bits.shape[1]):
        b = bits[:, j]
        hi, lo = _combine((hi, lo), (_mix32(b, 0x85EBCA6B, 0xC2B2AE35),
                                     _mix32(b, 0xCC9E2D51, 0x1B873593)))
    return hi, lo


def _hash_string(col: StringColumn):
    """Masked weighted byte sum, one lane per weight vector.  Each product
    is under 2**41 and a row sums at most 512 of them, so the int64 sum is
    exact before the 32-bit mask."""
    L = col.max_len
    if L > _MAX_HASH_LEN:
        raise ValueError(f"string max_len {L} > hashable {_MAX_HASH_LEN}")
    dev = col.data.device
    mask = (torch.arange(L, dtype=torch.int32, device=dev)[None, :]
            < col.lengths[:, None])
    b = torch.where(mask, col.data.to(torch.int64) + 1, 0)
    w1, w2 = _byte_weights()
    w1 = torch.from_numpy(w1[:L].astype(np.int64)).to(dev)
    w2 = torch.from_numpy(w2[:L].astype(np.int64)).to(dev)
    hi = (b * w1[None, :]).sum(dim=1) & M32
    lo = (b * w2[None, :]).sum(dim=1) & M32
    lens = to_u32(col.lengths)
    lenmix = (_mix32(lens, 0x85EBCA6B, 0xC2B2AE35),
              _mix32(lens, 0xCC9E2D51, 0x1B873593))
    return _combine((_mix32(hi, 0xCC9E2D51, 0x85EBCA6B),
                     _mix32(lo, 0x1B873593, 0xC2B2AE35)), lenmix)


def hash_column(col):
    if isinstance(col, StringColumn):
        return _hash_string(col)
    return _hash_dense(col)


def hash_columns(cols: Sequence):
    """Combined hash of several columns (row-wise)."""
    if not cols:
        raise ValueError("hash_columns needs at least one column")
    h = hash_column(cols[0])
    for c in cols[1:]:
        h = _combine(h, hash_column(c))
    return h


def hash_batch_keys(batch: Batch, key_names: Sequence[str]):
    """(hi, lo) int64 lanes in [0, 2**32) of the keys' 64-bit hash."""
    return hash_columns([batch.columns[k] for k in key_names])
