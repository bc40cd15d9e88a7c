"""Key hashing of the port (dryad_tpu_torch/ops/hashing.py) against the
JAX package's ops/hashing.py.  Tolerance: none — both 32-bit lanes must
be bit-identical, because the exchange sends row r to lo(hash) % P and
the two packages must agree on every destination."""

import numpy as np
import pytest
import torch

import jax

from dryad_tpu.data import columnar as jcol
from dryad_tpu.ops import hashing as jh
from dryad_tpu_torch.data import columnar as tcol
from dryad_tpu_torch.ops import hashing as th

N = 2_000


def _strings(rng, n):
    out = []
    for i in range(n):
        L = int(rng.randint(0, 20))
        b = bytes(rng.randint(0, 256, L).astype(np.uint8))
        out.append(b)
    out[:4] = [b"", b"\x00", b"\x00\x00", b"a" * 30]   # zeros, truncation
    return out


def _columns(kind, rng):
    if kind == "i32":
        return {"k": rng.randint(-2**31, 2**31 - 1, N).astype(np.int32)}
    if kind == "i64":
        return {"k": rng.randint(-2**62, 2**62, N).astype(np.int64)}
    if kind == "f32":
        v = rng.randn(N).astype(np.float32)
        v[:6] = [0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40]
        return {"k": v}
    if kind == "bool":
        return {"k": rng.rand(N) < 0.5}
    if kind == "i8":
        return {"k": rng.randint(-128, 128, N).astype(np.int8)}
    if kind == "str":
        return {"k": _strings(rng, N)}
    if kind == "multi":
        return {"k": _strings(rng, N),
                "j": rng.randint(0, 50, N).astype(np.int32)}
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["i32", "i64", "f32", "bool", "i8", "str",
                                  "multi"])
def test_hash_batch_keys_bit_exact(kind):
    rng = np.random.RandomState(7)
    cols = _columns(kind, rng)
    keys = list(cols)
    with jax.enable_x64(kind == "i64"):
        jb = jcol.batch_from_numpy(cols, str_max_len=24)
        jhi, jlo = (np.asarray(a) for a in jh.hash_batch_keys(jb, keys))
    tb = tcol.batch_from_numpy(cols, str_max_len=24, device="cpu")
    thi, tlo = th.hash_batch_keys(tb, keys)
    np.testing.assert_array_equal(thi.numpy(), jhi.astype(np.int64))
    np.testing.assert_array_equal(tlo.numpy(), jlo.astype(np.int64))


def test_signed_zero_hashes_alike():
    tb = tcol.batch_from_numpy({"k": np.array([0.0, -0.0], np.float32)},
                               device="cpu")
    hi, lo = th.hash_batch_keys(tb, ["k"])
    assert hi[0] == hi[1] and lo[0] == lo[1]


def test_byte_weights_identical():
    jw1, jw2 = jh._byte_weights()
    tw1, tw2 = th._byte_weights()
    assert tw1.dtype == jw1.dtype == np.uint32
    np.testing.assert_array_equal(tw1, jw1)
    np.testing.assert_array_equal(tw2, jw2)


@pytest.mark.parametrize("c", [0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF, 3])
def test_mul32_wraps_like_uint32(c):
    x = np.random.RandomState(c & 0xFFFF).randint(
        0, 2**32, 10_000, dtype=np.uint64).astype(np.uint32)
    got = th.mul32(torch.from_numpy(x.astype(np.int64)), c).numpy()
    np.testing.assert_array_equal(got, (x * np.uint32(c)).astype(np.int64))
