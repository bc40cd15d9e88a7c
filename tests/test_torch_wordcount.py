"""The slice end to end: WordCount through the port
(``dryad_tpu_torch``, device="cpu", nparts=8 — every kernel wrapper runs
its plain version) against WordCount through the JAX package on the
8-device CPU mesh and against a ``collections.Counter`` oracle.
Tolerance: none — the word -> count tables must be identical, including
when a capacity overflow forces a retry."""

import collections

import numpy as np
import pytest

from dryad_tpu import Context as JContext
from dryad_tpu.apps import wordcount as jwc
from dryad_tpu.plan.planner import plan_query
from dryad_tpu_torch import Context as TContext
from dryad_tpu_torch.apps import wordcount as twc
from dryad_tpu_torch.exec.executor import Executor
from tests.torch_threads import one_torch_thread  # noqa: F401

VOCAB = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lam", "mu"]


def _bench_lines(n, seed=0):
    """The JAX bench's WordCount corpus shape: 8 words a line from a
    12-word vocabulary."""
    rng = np.random.RandomState(seed)
    vocab = np.array(VOCAB)
    return [" ".join(vocab[i]) for i in rng.randint(0, len(vocab), (n, 8))]


def _zipf_lines(n, n_words=600, seed=1):
    """Synthetic lowercase words (lengths 3-10) sampled Zipf(1.1), some
    capitalized and punctuated so lowering and delimiters matter."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(3, 11, n_words)
    words = ["".join(chr(97 + c) for c in rng.randint(0, 26, L))
             for L in lens]
    p = 1.0 / np.arange(1, n_words + 1) ** 1.1
    idx = rng.choice(n_words, (n, 8), p=p / p.sum())
    out = []
    for row in idx:
        ws = [words[i] for i in row]
        ws[0] = ws[0].capitalize()
        out.append(" ".join(ws) + ".")
    return out


def _oracle(lines):
    c = collections.Counter()
    for line in lines:
        for w in line.replace(".", " ").split():
            c[w.lower().encode()] += 1
    return dict(c)


def _table(out):
    return dict(zip(out["line"], (int(v) for v in out["n"])))


def _run_both(lines, **kw):
    jctx = JContext()
    tctx = TContext(device="cpu", nparts=8)
    jout = jwc.wordcount(jctx, lines, max_line_len=96, **kw)
    tout = twc.wordcount(tctx, lines, max_line_len=96, **kw)
    return _table(jout), _table(tout)


@pytest.mark.parametrize("corpus", ["bench", "zipf"])
def test_wordcount_matches_jax_and_oracle(devices8, corpus):
    lines = _bench_lines(2_000) if corpus == "bench" else _zipf_lines(2_000)
    per_part = -(-len(lines) // 8)
    j, t = _run_both(lines, tokens_per_partition=per_part * 10)
    assert t == j
    assert t == _oracle(lines)


def _count_attempts(monkeypatch):
    calls = []
    orig = Executor._run_once

    def spy(self, stage, inp, scale, *rest):
        calls.append(scale)
        return orig(self, stage, inp, scale, *rest)

    monkeypatch.setattr(Executor, "_run_once", spy)
    return calls


def test_wordcount_capacity_retry_matches_jax(devices8, monkeypatch):
    """Too few token slots overflow the tokenizer; the NEED channel makes
    the executor retry at the measured scale, and no word is lost."""
    attempts = _count_attempts(monkeypatch)
    lines = _zipf_lines(1_000, seed=2)
    j, t = _run_both(lines, tokens_per_partition=256)
    assert attempts[0] == 1 and max(attempts) > 1
    assert t == j
    assert t == _oracle(lines)


def test_wordcount_per_row_bound_retry(monkeypatch):
    """A per-row token bound below the 8 words of a line retries too."""
    attempts = _count_attempts(monkeypatch)
    lines = _zipf_lines(1_000, seed=3)
    out = twc.wordcount(TContext(device="cpu", nparts=8), lines,
                        max_line_len=96, tokens_per_partition=2_000,
                        max_tokens_per_row=3)
    assert len(attempts) > 1
    assert _table(out) == _oracle(lines)


@pytest.mark.parametrize("nparts", [1, 3])
def test_wordcount_other_partition_counts(nparts):
    """One partition plans without an exchange; three split the rows
    unevenly and hash to a non-power-of-two mesh.  Port only, against
    the oracle."""
    lines = _zipf_lines(700, seed=4)
    out = twc.wordcount(TContext(device="cpu", nparts=nparts), lines,
                        max_line_len=96, tokens_per_partition=3_000)
    assert _table(out) == _oracle(lines)


def test_plan_matches_jax(devices8):
    """P = 8 lowers WordCount to the same stages as the JAX planner."""
    lines = _bench_lines(64)
    jq = jwc.wordcount_query(JContext().from_columns({"line": lines}))
    tq = twc.wordcount_query(TContext(device="cpu", nparts=8)
                             .from_columns({"line": lines}))
    jplan = plan_query(jq.node, 8).explain()
    assert tq.explain() == jplan
    assert "=>hash(line)" in jplan
