"""Key columns for the tests of the key hash kernel
(``dryad_tpu_torch/ops/csrc/hash_keys.cu``), made from fixed seeds with
numpy, and the digests of the JAX package's hashes of them.

``JAX_DIGESTS`` are the JAX package's (hi, lo) lanes of each case on the
CPU (``tests/test_torch_hashing.py`` recomputes them), so the card tests,
which do not import JAX, hold the kernel to the JAX package through them.
The cases under ``PLAIN_ONLY`` are held to the port's plain version alone,
because the two packages already differ there: float64 keys that round
to float32 subnormals, which the port keeps and the JAX package's XLA
backend flushes to zero, and float16 subnormals, which the port makes
+0.0 and the JAX package keeps."""

import hashlib

import numpy as np

N = 2_000


def _strings(rng, n, longest=20):
    out = []
    for _ in range(n):
        L = int(rng.randint(0, longest))
        out.append(bytes(rng.randint(0, 256, L).astype(np.uint8)))
    if n >= 4:
        out[:4] = [b"", b"\x00", b"\x00\x00", b"a" * (longest + 10)]
    return out


def _f64(rng, n):
    v = rng.randn(n) * 1e3
    v[:14] = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e300, -1e300,
              3.4028236e38, 5e-324, -2e-308, 1e-50, -1e-50, 1.5]
    return v


# name -> (seed, str_max_len, capacity over the rows, whether int64 /
# float64 stay 64-bit in the JAX package)
CASES = {
    "i32": (7, 24, 0, False), "i64": (7, 24, 0, True),
    "f32": (7, 24, 0, False), "bool": (7, 24, 0, False),
    "i8": (7, 24, 0, False), "str": (7, 24, 0, False),
    "multi": (7, 24, 0, False), "f64": (11, 24, 0, True),
    "i64x3": (12, 24, 0, True), "str512": (13, 512, 0, False),
    "zero": (14, 24, 0, False), "padded": (15, 24, 37, False),
    "f64_sub": (16, 24, 0, True), "u8": (17, 24, 0, False),
    "i16": (18, 24, 0, False), "u32": (19, 24, 0, False),
    "f16": (20, 24, 0, False), "f32x2": (21, 24, 0, False),
    "wide40": (22, 24, 0, True),
}
PLAIN_ONLY = ("f64_sub", "f16")


def columns(kind: str):
    """The case's columns: numpy arrays, or lists of bytes for strings."""
    rng = np.random.RandomState(CASES[kind][0])
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
    if kind == "f64":
        return {"k": _f64(rng, N)}
    if kind == "i64x3":
        v = rng.randint(-2**62, 2**62, (N, 3)).astype(np.int64)
        v[:, 1] = v[:, 0] >> 32     # element 1 is element 0's high word
        return {"k": v}
    if kind == "str512":
        return {"k": _strings(rng, 300, longest=600),
                "j": rng.randint(0, 9, 300).astype(np.int32)}
    if kind == "zero":
        return {"k": np.zeros(0, np.int32), "j": np.zeros(0, np.int64)}
    if kind == "padded":
        return {"k": rng.randint(-9, 9, N).astype(np.int32),
                "s": _strings(rng, N)}
    if kind == "f64_sub":
        v = rng.randn(N)
        v[:6] = [1e-40, -1e-40, 1e-44, 3e-39, -1.1e-38, 1e-45]
        return {"k": v}
    if kind == "u8":
        return {"k": rng.randint(0, 256, N).astype(np.uint8)}
    if kind == "i16":
        return {"k": rng.randint(-2**15, 2**15, N).astype(np.int16)}
    if kind == "u32":
        return {"k": rng.randint(0, 2**32, N, dtype=np.int64)
                .astype(np.uint32)}
    if kind == "f16":
        v = (rng.randn(N) * 100).astype(np.float16)
        v[:6] = [0.0, -0.0, np.inf, -np.inf, 1e-7, -3e-6]   # subnormals
        return {"k": v}
    if kind == "f32x2":
        v = rng.randn(N, 2).astype(np.float32)
        v[:3] = [[0.0, -0.0], [1e-40, np.inf], [-0.0, -1e-41]]
        return {"k": v, "j": rng.randint(0, 3, N).astype(np.int8)}
    if kind == "wide40":
        # 40 key columns, more than one launch takes: int32 but for a
        # float32, a string and an int64 on either side of the 32nd
        cols = {f"c{i:02d}": rng.randint(-2**31, 2**31 - 1, N)
                .astype(np.int32) for i in range(40)}
        cols["c02"] = rng.randn(N).astype(np.float32)
        cols["c31"] = _strings(rng, N)
        cols["c35"] = rng.randint(-2**62, 2**62, N).astype(np.int64)
        return cols
    raise ValueError(kind)


def capacity(kind: str, cols) -> int:
    n = len(next(iter(cols.values())))
    return n + CASES[kind][2]


def digest(hi, lo) -> str:
    """Of the two lanes as little-endian uint32 (numpy arrays of values in
    [0, 2**32))."""
    h = hashlib.sha256(np.asarray(hi).astype("<u4").tobytes())
    h.update(np.asarray(lo).astype("<u4").tobytes())
    return h.hexdigest()[:16]


JAX_DIGESTS = {
    "i32": "d3becc66b69218ed", "i64": "b85b1e8d431fe581",
    "f32": "2366ebf35fc8c294", "bool": "ecce59375789e863",
    "i8": "0e5b3bfc3ba17c8f", "str": "14e287a5b242189f",
    "multi": "2c7f2f2cc1b5fff7", "f64": "f8e366dc86d9a111",
    "i64x3": "a068ace2c286518e", "str512": "75a23536a7efbc42",
    "zero": "e3b0c44298fc1c14", "padded": "5bf8885ea0184e4f",
    "u8": "2a006627a5598966", "i16": "57dfc3868ece0c96",
    "u32": "79d0741f67c5a068", "f32x2": "bd7b2a55831b39e2",
    "wide40": "54ae014841f72254",
}
