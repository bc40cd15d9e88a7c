#!/usr/bin/env python3
"""Drive the PyTorch port (dryad_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--lines N] [--out DIR]

Phases, each failing the run (non-zero exit, no result line) on error:

  0. the card's name and power limit (``nvidia-smi``); no CUDA -> exit 2;
  1. build: every Hopper kernel of the WordCount path compiles from
     ``dryad_tpu_torch/ops/csrc`` (one nvcc per source, all at once);
  2. kernels: each kernel against its plain PyTorch version on the card,
     at edge shapes (n = 0 and 1, ragged tiles, sentinels and negative
     ids, D = 1/8/16, C < 8, counts 0 and >= C, out_rows below the total).
     Integers must match exactly; the f32 scan within 1e-5 x max|prefix|
     of a float64 cumsum (the additions run in another order);
  3. WordCount through ``Context(device="cuda", nparts=8)`` on two
     corpora of N lines (default 1,000,000: the JAX bench's 12-word
     vocabulary corpus, and 50,000 synthetic words sampled Zipf(1.1)),
     held exactly against a ``collections.Counter`` oracle; every launch
     counter must have risen during each run;
  4. timing: each kernel, its plain version and one library call at the
     largest shapes the main path gave it (CUDA events), the bound the
     card's memory rate sets for the same bytes, and a torch.profiler
     breakdown of one warm run.

Output: one JSON line per corpus and per kernel, then the card line, then
the ``{"kernels": [...]}`` line, then the result line
``{"ok": true, "device": {...}}`` last.  Long logs (nvcc -Xptxas -v, the
profile) go under ``--out`` (default chiprun_out/).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak bandwidth
PEAK_OPS_PER_S = 67e12       # H100 SXM non-tensor float32; int32 adds are
                             # counted at the same rate
NPARTS = 8                   # logical partitions on the one card
F32_TOL = 1e-5               # x max|prefix|, as tests/test_pallas_kernels

TPU_KERNEL = {   # the Pallas function each kernel replaces
    "hist_buckets": "dryad_tpu/ops/pallas_kernels.py:137",
    "prefix_sum": "dryad_tpu/ops/pallas_kernels.py:270",
    "slot_expand": "dryad_tpu/ops/pallas_kernels.py:384",
    "slot_compact": "dryad_tpu/ops/pallas_kernels.py:445",
}
DEVICE_NAMES = {  # substrings of the compiled kernels' names
    "hist_buckets": ("hist_shared", "hist_global"),
    "prefix_sum": ("tile_totals", "scan_totals", "tile_scan_offset"),
    "slot_expand": ("slot_expand_k",),
    "slot_compact": ("slot_compact_k",),
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def import_port():
    """The port from this checkout, never from anywhere else."""
    sys.path.insert(0, HERE)
    import dryad_tpu_torch
    pkg = os.path.dirname(os.path.abspath(dryad_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise RuntimeError(f"dryad_tpu_torch imported from {pkg}, not from "
                           f"this checkout {HERE}")
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "dryad_tpu" or m.startswith("dryad_tpu.")]
    if bad:
        raise RuntimeError(f"the port pulled in {bad}")
    return dryad_tpu_torch


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def check_kernels(hk, dev) -> None:
    """Each kernel against its plain version at edge shapes."""
    import torch
    rng = np.random.RandomState(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def same(name, got, want, what):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{name} {what}: kernel != plain")

    for n, nb in [(0, 4), (1, 5), (4097, 8), (1_000_003, 8), (70_000, 513),
                  (200_000, 20_000)]:
        bid = rng.randint(0, nb, n).astype(np.int32)
        bid[::7] = nb
        bid[::11] = -3
        x = t(bid)
        same("hist_buckets", hk.hist_buckets(x, nb),
             hk.hist_buckets_plain(x, nb), f"n={n} nb={nb}")

    for n in [0, 1, 4095, 4096, 4097, 1_250_000, 20_000_001]:
        xi = t(rng.randint(-2**31, 2**31 - 1, n).astype(np.int32))
        same("prefix_sum", hk.prefix_sum(xi), hk.prefix_sum_plain(xi),
             f"i32 n={n}")
        yu = hk.prefix_sum(xi.view(torch.uint32)).view(torch.int32)
        same("prefix_sum", yu, hk.prefix_sum_plain(xi), f"u32 n={n}")
        xf = rng.rand(n).astype(np.float32)
        yf = hk.prefix_sum(t(xf)).cpu().numpy().astype(np.float64)
        ref = np.cumsum(xf.astype(np.float64))
        if n:
            e = float(np.abs(yf - ref).max())
            if e > F32_TOL * float(np.abs(ref).max()):
                raise AssertionError(f"prefix_sum f32 n={n}: err {e}")

    for cap, W, D, C in [(64, 3, 1, 5), (500, 8, 8, 3), (65_536, 8, 8, 16_384),
                         (10_000, 7, 16, 700), (300, 2, 8, 300)]:
        words = t(rng.randint(-2**31, 2**31 - 1, (cap, W)).astype(np.int32))
        cnt = rng.randint(0, 2 * cap // D + 2, D)
        offs = np.cumsum(cnt) - cnt
        offs[-1] = cap - 1          # a run that reads into the zero pad
        offs = t(offs.astype(np.int32))
        same("slot_expand", hk.slot_expand(words, offs, C),
             hk.slot_expand_plain(words, offs, C), f"D={D} C={C}")

    for D, C, W, out_rows in [(1, 10, 3, 12), (8, 16, 4, 40), (8, 16, 4, 200),
                              (16, 5, 2, 90), (8, 16_384, 8, 1_250_000),
                              (8, 16_384, 8, 70_000)]:
        words = t(rng.randint(-2**31, 2**31 - 1, (D * C, W)).astype(np.int32))
        counts = rng.randint(0, C + 1, D).astype(np.int32)
        counts[0] = 0
        counts[-1] = C + 9
        counts = t(counts)
        same("slot_compact", hk.slot_compact(words, counts, C, out_rows),
             hk.slot_compact_plain(words, counts, C, out_rows),
             f"D={D} C={C} out_rows={out_rows}")


# ---------------------------------------------------------------------------
# phase 3: WordCount


def bench_corpus(n: int):
    """The JAX bench's WordCount corpus (bench.py): 8 words a line from a
    12-word vocabulary, numpy seed 0."""
    rng = np.random.RandomState(0)
    vocab = np.array(["alpha", "beta", "gamma", "delta", "epsilon", "zeta",
                      "eta", "theta", "iota", "kappa", "lam", "mu"])
    idx = rng.randint(0, len(vocab), (n, 8))
    return [" ".join(vocab[i]) for i in idx]


def zipf_corpus(n: int, n_words: int = 50_000):
    """Same shape, 50,000 synthetic lowercase words (lengths 3-10, numpy
    seed 1) sampled Zipf(s=1.1): tens of thousands of groups per
    partition, so the exchange moves real rows."""
    rng = np.random.RandomState(1)
    lens = rng.randint(3, 11, n_words)
    letters = rng.randint(0, 26, (n_words, 10)).astype(np.uint8) + ord("a")
    words = np.array([letters[i, :lens[i]].tobytes().decode()
                      for i in range(n_words)])
    p = 1.0 / np.arange(1, n_words + 1) ** 1.1
    idx = rng.choice(n_words, (n, 8), p=p / p.sum())
    return [" ".join(words[i]) for i in idx]


def oracle(lines) -> dict:
    c = collections.Counter()
    for line in lines:
        c.update(line.encode().split())
    return c


def run_wordcount(port, hk, wc, lines):
    """One main-path run through the user's entry points (what
    ``wordcount()`` does, timed in two parts: host packing + copy to the
    card, then the query and collect).  Counters zeroed just before, read
    just after.  Returns (table, launches, load_s, query_s)."""
    import torch
    ctx = port.Context(device="cuda", nparts=NPARTS)
    per_part = -(-len(lines) // NPARTS)
    hk.reset_launches()
    t0 = time.perf_counter()
    ds = ctx.from_columns({"line": lines}, str_max_len=96)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = wc.wordcount_query(ds, tokens_per_partition=per_part * 10).collect()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return out, dict(hk.launches), t1 - t0, t2 - t1


# ---------------------------------------------------------------------------
# phase 4: timing


def cuda_ms(fn, reps: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def work(name: str, args) -> tuple:
    """(bytes the function must move, operations it does) for these
    inputs: each input byte read once, each output byte written once."""
    import torch
    if name == "hist_buckets":
        bid, nb = args
        return 4 * bid.numel() + 4 * nb, bid.numel()
    if name == "prefix_sum":
        (x,) = args
        return 8 * x.numel(), x.numel()
    if name == "slot_expand":
        # rows read: the union of the runs [start, min(start + C, cap)),
        # which overlap (C exceeds the fair share); rows written: D*C
        words, offs, C = args
        cap, W = words.shape
        real = reach = 0
        for s in sorted(offs.long().clamp(0, cap).tolist()):
            s, e = max(s, reach), min(s + C, cap)
            real += max(e - s, 0)
            reach = max(reach, e)
        return 4 * W * (real + offs.numel() * C) + 4 * offs.numel(), 0
    words, counts, C, out_rows = args
    W = words.shape[1]
    valid = min(int(counts.long().clamp(0, C).sum()), out_rows)
    return 4 * W * (valid + out_rows) + 4 * counts.numel(), 0


def library_call(name: str, args):
    """PyTorch's library ops computing the same function, output for
    output (a yardstick only; the port never calls it), or None.  The
    slot kernels have no one-call counterpart: theirs is the gather index
    built from the offsets/counts, then one ``index_select`` (into a
    zeroed output for ``slot_compact``), all inside the timed call."""
    import torch
    if name == "hist_buckets":
        bid, nb = args
        return lambda: torch.bincount(bid, minlength=nb + 1)[:nb]
    if name == "prefix_sum":
        (x,) = args
        return lambda: torch.cumsum(x, 0, dtype=x.dtype)
    if name == "slot_expand":
        words, offs, C = args
        cap, W = words.shape

        def expand():
            xp = torch.cat([words, words.new_zeros((C, W))])
            src = (offs.long().clamp(0, cap)[:, None]
                   + torch.arange(C, device=words.device)[None, :])
            return xp.index_select(0, src.reshape(-1))
        return expand
    words, counts, C, out_rows = args

    def compact():
        cnt = counts.long().clamp(0, C)
        idx = torch.arange(words.shape[0], device=words.device)
        keep = (idx % C) < cnt[idx // C]
        src = torch.nonzero(keep).squeeze(1)[:out_rows]
        out = words.new_zeros((out_rows, words.shape[1]))
        torch.index_select(words, 0, src, out=out[:src.numel()])
        return out
    return compact


def time_kernels(hk, captured, launches, prof, card) -> list:
    import torch
    plain = {"hist_buckets": hk.hist_buckets_plain,
             "prefix_sum": hk.prefix_sum_plain,
             "slot_expand": hk.slot_expand_plain,
             "slot_compact": hk.slot_compact_plain}
    wrapper = {"hist_buckets": hk.hist_buckets, "prefix_sum": hk.prefix_sum,
               "slot_expand": hk.slot_expand,
               "slot_compact": hk.slot_compact}
    rows = []
    for name in TPU_KERNEL:
        _size, args = captured[name]
        got, want = wrapper[name](*args), plain[name](*args)
        torch.cuda.synchronize()
        if got.dtype == torch.float32:
            mae = float((got.double() - want.double()).abs().max())
        else:
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: kernel != plain at the main "
                                     f"path's shapes")
            mae = 0.0
        nbytes, ops = work(name, args)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S * 1e3
        lib = library_call(name, args)
        if lib is not None and got.dtype != torch.float32:
            ref = lib()
            if ref.shape != want.shape or not torch.equal(
                    ref.to(want.dtype), want):
                raise AssertionError(f"{name}: the library yardstick does "
                                     f"not compute the same function")
        rows.append({
            "name": name, "route": "cuda",
            "source": f"dryad_tpu_torch/ops/csrc/{name}.cu",
            "replaces": TPU_KERNEL[name],
            "launches": launches[name],
            "max_abs_err": mae,
            "ms": cuda_ms(lambda: wrapper[name](*args)),
            "plain_ms": cuda_ms(lambda: plain[name](*args)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": cuda_ms(lib) if lib is not None else None,
            # device time alone, per launch, from the profiled warm run
            # (ms above also holds the host's launch gaps)
            "profiled_device_ms_per_launch": (
                prof["port_kernels_ms"][name] / launches[name]
                if prof.get("port_kernels_ms") else None),
            "shape": [list(a.shape) if hasattr(a, "shape") else a
                      for a in args],
            "bytes": nbytes,
            "card": card,
        })
    return rows


def profile_run(port, hk, wc, lines, out_dir) -> dict:
    """Device time by kernel over one warm WordCount run (kernel-level
    events only: the operator-level rows repeat their kernels' time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _out, _l, load, query = run_wordcount(port, hk, wc, lines)
    wall = load + query
    avgs = prof.key_averages()
    with open(os.path.join(out_dir, "profile_key_averages.txt"), "w") as f:
        f.write(avgs.table(sort_by="self_cuda_time_total", row_limit=60))
    dev_ms = collections.Counter()
    for ev in avgs:
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_ms[ev.key] += ev.self_device_time_total / 1e3
    if not dev_ms:
        return {"device_ms": None, "wall_s": wall, "load_s": load,
                "query_s": query}
    ours = {k: sum(v for key, v in dev_ms.items()
                   if any(s in key for s in subs))
            for k, subs in DEVICE_NAMES.items()}
    total = sum(dev_ms.values())
    return {"wall_s": wall, "load_s": load, "query_s": query,
            "device_ms": total,
            "device_busy_share": total / 1e3 / wall,
            "port_kernels_ms": ours,
            "rest_ms": total - sum(ours.values()),
            "top": [[k[:120], v] for k, v in dev_ms.most_common(10)]}


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lines", type=int, default=1_000_000)
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out"))
    a = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    os.makedirs(a.out, exist_ok=True)

    port = import_port()
    from dryad_tpu_torch.apps import wordcount as wc
    from dryad_tpu_torch.ops import _build
    from dryad_tpu_torch.ops import hopper_kernels as hk
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    with open(os.path.join(a.out, "nvcc_ptxas.log"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "kernels": sorted(logs), "card": card}), flush=True)

    check_kernels(hk, dev)
    print(json.dumps({"phase": "kernels", "ok": True, "card": card}),
          flush=True)

    corpora = {"bench12": bench_corpus(a.lines),
               "zipf50k": zipf_corpus(a.lines)}
    # the kernel line reports the last corpus's main-path run (zipf50k:
    # its exchange moves real rows): its launches, its kernel inputs
    for cname, lines in corpora.items():
        want = oracle(lines)
        hk.capture = {}
        out, launches, load, query = run_wordcount(port, hk, wc, lines)
        captured, hk.capture = hk.capture, None
        got = dict(zip(out["line"], (int(v) for v in out["n"])))
        if got != want:
            diff = [(k, got.get(k), want.get(k)) for k in
                    set(got) | set(want) if got.get(k) != want.get(k)]
            raise AssertionError(f"{cname}: {len(diff)} words differ from "
                                 f"the oracle, e.g. {diff[:5]}")
        zero = [k for k, v in launches.items() if v == 0]
        if zero:
            raise AssertionError(f"{cname}: kernels never launched: {zero}")
        _, _, wload, wquery = run_wordcount(port, hk, wc, lines)
        warm = wload + wquery
        print(json.dumps({
            "corpus": cname, "lines": len(lines), "nparts": NPARTS,
            "words": len(want), "tokens": sum(want.values()),
            "launches": launches, "cold_wall_s": load + query,
            "warm_wall_s": warm, "warm_load_s": wload,
            "warm_query_s": wquery, "lines_per_s": len(lines) / warm,
            "card": card}), flush=True)

    prof = profile_run(port, hk, wc, corpora["zipf50k"], a.out)
    print(json.dumps({"profile": "zipf50k warm run", **prof, "card": card}),
          flush=True)
    rows = time_kernels(hk, captured, launches, prof, card)
    for row in rows:
        print(json.dumps({"kernel": row}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
