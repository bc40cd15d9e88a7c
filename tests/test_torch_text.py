"""The port's tokenizer (dryad_tpu_torch/ops/text.py) against the JAX
package's ops/text.py, partition by partition.  Tolerance: none — token
multisets, per-token counts, token counts and the NEED values must be
identical (the prefix_sum these functions call runs its plain version on
CPU tensors; the JAX side uses its XLA fallback and, once, its
interpreted Pallas kernel)."""

import collections

import numpy as np
import pytest

import jax

from dryad_tpu.data import columnar as jcol
from dryad_tpu.ops import pallas_kernels as jk
from dryad_tpu.ops import text as jt
from dryad_tpu_torch.data import columnar as tcol
from dryad_tpu_torch.ops import text as tt
from tests.torch_threads import one_torch_thread  # noqa: F401

WORDS = ["alpha", "Beta", "GAMMA", "delta", "x",
         "averyveryverylongtokenthatgetstruncated", "it's", "(paren)",
         "end.", "a,b;c", "tab\there", "ümlaut"]


# one compiled program per call shape instead of op-by-op dispatch
_j_split = jax.jit(jt.split_tokens, static_argnums=(1, 2),
                   static_argnames=("max_token_len", "max_tokens_per_row"))
_j_tgc = jax.jit(jt.tokenize_group_count, static_argnums=(1,),
                 static_argnames=("out_capacity", "vocab_capacity",
                                  "count_name", "max_token_len", "lower",
                                  "max_tokens_per_row"))


def _lines(seed, n, max_words=9):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        k = int(rng.randint(0, max_words + 1))
        sep = [" ", "  ", "\t", " . "]
        out.append("".join(WORDS[int(rng.randint(len(WORDS)))]
                           + sep[int(rng.randint(4))] for _ in range(k)))
    return out


def _batches(seed, n, cap, L):
    lines = _lines(seed, n)
    cols = {"line": lines}
    jb = jcol.batch_from_numpy(cols, capacity=cap, str_max_len=L)
    tb = tcol.batch_from_numpy(cols, capacity=cap, str_max_len=L,
                               device="cpu")
    return jb, tb


def _token_list(col_data, lens, count):
    data = np.asarray(col_data)[:count]
    lens = np.asarray(lens)[:count]
    return [bytes(data[i, :lens[i]]) for i in range(count)]


@pytest.mark.parametrize("mtr", [None, 6])
@pytest.mark.parametrize("n,cap,L", [(300, 320, 48), (0, 16, 8),
                                     (150, 150, 96)])
def test_split_tokens_matches_jax(n, cap, L, mtr):
    jb, tb = _batches(n + L, n, cap, L)
    oc = 4 * cap
    jout, jneed = _j_split(jb, "line", oc, max_token_len=12,
                                  max_tokens_per_row=mtr)
    tout, tneed = tt.split_tokens(tb, "line", oc, max_token_len=12,
                                  max_tokens_per_row=mtr)
    jc, tc = int(jout.count), int(tout.count)
    assert tc == jc
    assert int(tneed) == int(jneed)
    jcolm = jout.columns["line"]
    # split_tokens keeps the token stream's order: compare exactly
    assert tcol.batch_to_numpy(tout)["line"] == \
        _token_list(jcolm.data, jcolm.lengths, jc)


def _groups(out, col="line", cnt="n"):
    c = int(out.count)
    toks = _token_list(out.columns[col].data, out.columns[col].lengths, c)
    counts = np.asarray(out.columns[cnt])[:c]
    return dict(zip(toks, counts.tolist())), toks


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("lower", [False, True])
def test_tokenize_group_count_matches_jax(lower, interpret):
    jb, tb = _batches(3, 400, 416, 64)
    kw = dict(out_capacity=6000, vocab_capacity=64, count_name="n",
              max_token_len=10, lower=lower, max_tokens_per_row=40)
    if interpret:
        with jk.force_interpret():
            jout, jneed = _j_tgc(jb, "line", **kw)
    else:
        jout, jneed = _j_tgc(jb, "line", **kw)
    tout, tneed = tt.tokenize_group_count(tb, "line", **kw)
    assert int(tneed) == int(jneed) == 0
    jg, jorder = _groups(jout)
    tg, torder = _groups(tout)
    assert tg == jg
    # bit-exact hashes give the same group order too
    assert torder == jorder
    assert tg == _oracle(_lines(3, 400), 64, 10, lower)


def _oracle(lines, L, max_token_len, lower):
    c = collections.Counter()
    for line in lines:
        b = line.encode()[:L]
        for ch in b" \t\r\n.,;:!?\"'()[]{}<>":
            b = b.replace(bytes([ch]), b" ")
        for w in b.split(b" "):
            if w:
                w = w[:max_token_len]
                c[w.lower() if lower else w] += 1
    return dict(c)


@pytest.mark.parametrize("case", ["tokens", "vocab", "row"])
def test_need_agrees_on_overflow(case):
    jb, tb = _batches(5, 200, 200, 64)
    kw = dict(out_capacity=2000, vocab_capacity=64, count_name="n",
              max_token_len=10, max_tokens_per_row=12)
    if case == "tokens":
        kw["out_capacity"] = 100
    elif case == "vocab":
        kw["vocab_capacity"] = 4
    else:
        kw["max_tokens_per_row"] = 2
    jout, jneed = _j_tgc(jb, "line", **kw)
    tout, tneed = tt.tokenize_group_count(tb, "line", **kw)
    assert int(jneed) > 0
    assert int(tneed) == int(jneed)
    assert int(tout.count) == int(jout.count)
    if case == "tokens":
        jo, jn = _j_split(jb, "line", 100, max_token_len=10)
        to, tn = tt.split_tokens(tb, "line", 100, max_token_len=10)
        assert int(tn) == int(jn) > 0


def test_lower_ascii_matches_jax():
    jb, tb = _batches(9, 50, 50, 40)
    jl = np.asarray(jt.lower_ascii(jb.columns["line"]).data)
    tl = tt.lower_ascii(tb.columns["line"]).data.numpy()
    np.testing.assert_array_equal(tl, jl)
