"""64-bit hashing of record keys as two 32-bit lanes — bit-exact with
``dryad_tpu/ops/hashing.py``.

The JAX package computes in wrapping ``uint32``.  PyTorch's ``uint32``
lacks most arithmetic, so the port carries every 32-bit lane as
``int64`` holding a value in [0, 2**32): additions and xors are masked
back to 32 bits, right shifts are then logical, and a product with a
32-bit constant is split into 16-bit halves so that no intermediate
leaves int64 (``mul32``).  The results are the JAX package's hashes bit
for bit, which is what makes the exchange destinations ``lo % D`` agree.

``hash_batch_keys`` routes like the wrappers of ``hopper_kernels``: CUDA
columns go to the hand-written kernel ``hash_keys``
(``csrc/hash_keys.cu``: every key column of the call in one launch, or
one per 32 columns, in uint32 registers), CPU columns and, inside
``shape_only()``, meta columns to the plain version ``hash_columns``
above it, whose bits the kernel reproduces; any other device, or a mix,
raises.
"""

from __future__ import annotations

import threading
from typing import Sequence, Tuple

import numpy as np
import torch

from dryad_tpu_torch.data.columnar import Batch, StringColumn
from dryad_tpu_torch.obs import trace
from dryad_tpu_torch.ops import _build
from dryad_tpu_torch.ops import hopper_kernels as hk

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


# the kernel's column kinds (the k* constants of csrc/hash_keys.cu)
_KIND = {torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.uint16: 3,
         torch.int32: 4, torch.uint32: 4, torch.int64: 5, torch.uint64: 5,
         torch.bool: 6, torch.float16: 7, torch.bfloat16: 8,
         torch.float32: 9, torch.float64: 10}
_KIND_STR = 11
_MAX_KEY_COLS = 32           # kMaxCols of csrc/hash_keys.cu: columns a launch

# device index -> the byte weights on it (both vectors, as int32 bits),
# made at the first string key hashed there
_weights_on = {}
_WEIGHTS_LOCK = threading.Lock()


def _device_weights(dev: torch.device) -> torch.Tensor:
    with _WEIGHTS_LOCK:
        w = _weights_on.get(dev.index)
        if w is None:
            w1, w2 = _byte_weights()
            w = torch.from_numpy(np.concatenate([w1, w2]).view(np.int32)
                                 ).to(dev)
            # landed before any stream's launch reads them
            torch.cuda.current_stream(dev).synchronize()
            _weights_on[dev.index] = w
        return w


def _tensors(cols):
    for c in cols:
        if isinstance(c, StringColumn):
            yield c.data
            yield c.lengths
        else:
            yield c


def _descriptor(col):
    """(the kernel's 7-word descriptor of one key column, the tensor it
    points into)."""
    if isinstance(col, StringColumn):
        data, lens = col.data, col.lengths
        L = col.max_len
        if L > _MAX_HASH_LEN:
            raise ValueError(f"string max_len {L} > hashable "
                             f"{_MAX_HASH_LEN}")
        if data.dtype != torch.uint8 or lens.dtype != torch.int32:
            raise TypeError(f"hash_keys: string bytes {data.dtype} and "
                            f"lengths {lens.dtype}, not uint8 and int32")
        if lens.shape != data.shape[:1]:
            raise ValueError(f"hash_keys: {tuple(lens.shape)} lengths for "
                             f"{data.shape[0]} strings")
        if data.stride(1) != 1:
            data = data.contiguous()
        return ((data.data_ptr(), lens.data_ptr(), data.stride(0), 1,
                 lens.stride(0), _KIND_STR, L), data)
    kind = _KIND.get(col.dtype)
    if kind is None:
        raise TypeError(f"hash_keys: no kernel for key dtype {col.dtype}")
    if col.dim() not in (1, 2):
        raise ValueError(f"hash_keys: key columns are [n] or [n, k], got "
                         f"{tuple(col.shape)}")
    es = col.element_size()
    wide = col.dim() == 2
    return ((col.data_ptr(), 0, col.stride(0) * es,
             col.stride(1) * es if wide else 0, 0, kind,
             col.shape[1] if wide else 1), col)


def _hash_keys(cols: Sequence):
    """The kernel ``hash_keys`` on CUDA key columns (the caller routed
    them): ``hash_columns``' bits in one launch over every column, or one
    per ``_MAX_KEY_COLS`` columns, each later launch combining its columns
    into the lanes the one before wrote.  A zero-row call launches
    nothing."""
    n = (cols[0].capacity if isinstance(cols[0], StringColumn)
         else cols[0].shape[0])
    desc, held = [], []     # held: the tensors read, kept to the launch
    for col in cols:
        d, t = _descriptor(col)
        if t.shape[0] != n:
            raise ValueError(f"hash_keys: key columns of {t.shape[0]} and "
                             f"{n} rows")
        desc.append(d)
        held.append(t)
    dev = held[0].device
    hi = torch.empty(n, dtype=torch.int64, device=dev)
    lo = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return hi, lo
    weights = (_device_weights(dev) if any(
        isinstance(c, StringColumn) for c in cols) else None)
    desc = np.asarray(desc, dtype=np.int64)
    lib = _build.library("hash_keys")
    stream = hk._stream(hi)
    for first in range(0, len(cols), _MAX_KEY_COLS):
        chunk = desc[first:first + _MAX_KEY_COLS]
        hk._ok("hash_keys", lib.dryad_hash_keys(
            chunk.ctypes.data, len(chunk), n,
            None if weights is None else weights.data_ptr(), int(first > 0),
            hi.data_ptr(), lo.data_ptr(), stream))
        hk._launched("hash_keys")
    return hi, lo


def hash_batch_keys(batch: Batch, key_names: Sequence[str]):
    """(hi, lo) int64 lanes in [0, 2**32) of the keys' 64-bit hash: the
    kernel for CUDA columns, ``hash_columns`` for CPU ones (and meta ones
    inside ``shape_only()``).  In a ``hash`` span when tracing
    (``obs/trace.py``; ``rows``: the batch's capacity; ``route``:
    ``"kernel"`` or ``"plain"``)."""
    cols = [batch.columns[k] for k in key_names]
    if not cols:
        raise ValueError("hash_columns needs at least one column")
    fn = _hash_keys if hk._on_card("hash_keys", *_tensors(cols)) \
        else hash_columns
    if trace.ACTIVE:
        with trace.scope("hash", "op", {
                "rows": batch.capacity, "keys": len(key_names),
                "route": "kernel" if fn is _hash_keys else "plain"}):
            return fn(cols)
    return fn(cols)
