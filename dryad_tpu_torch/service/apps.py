"""Registered service apps (the port of ``dryad_tpu/service/apps.py``):
named, parameterized jobs clients submit
over the HTTP front end (the service-side analog of the reference's
precompiled query packages — DryadLINQ ships a compiled vertex DLL per
query; we ship a NAME and parameters, and the daemon builds/caches the
plan once so the Nth user pays zero planning).

Each app provides the three things the daemon needs:

* ``make_tasks(params, nparts)`` — deterministic per-task column blocks;
* ``build_query(ctx, columns, params, capacity)`` — the Dataset query
  over one task's columns (used both to serialize the cluster plan from
  a template task and to run in-process jobs).  The daemon passes a
  UNIFORM per-partition ``capacity`` (sized to the largest task) so
  every task — and every later submission with the same parameters —
  hits the same compiled stage programs while row counts stay honest;
* ``combine(tables)`` — fold the per-task host tables into the
  JSON-able job result.

Custom one-off jobs don't register here: the Python API accepts raw
``(plan_json, per_task_sources)`` payloads (``JobService.submit_tasks``)
and in-process callables (``JobService.submit_callable``).
"""

from __future__ import annotations

import random
from collections import Counter
from typing import Any, Callable, Dict, List

from dryad_tpu_torch.service.tenancy import UnknownAppError

__all__ = ["APPS", "ServiceApp", "get_app", "task_capacity"]


class ServiceApp:
    def __init__(self, name: str,
                 make_tasks: Callable[[dict, int], List[dict]],
                 build_query: Callable[..., Any],
                 combine: Callable[[List], Any],
                 str_max_len: int = 64):
        self.name = name
        self.make_tasks = make_tasks
        self.build_query = build_query
        self.combine = combine
        self.str_max_len = str_max_len


APPS: Dict[str, ServiceApp] = {}


def get_app(name: str) -> ServiceApp:
    try:
        return APPS[name]
    except KeyError:
        raise UnknownAppError(name, APPS.keys())


def _register(app: ServiceApp) -> ServiceApp:
    APPS[app.name] = app
    return app


def _rows(columns: dict) -> int:
    for v in columns.values():
        return len(v)
    return 0


def task_capacity(tasks: List[dict], nparts: int) -> int:
    """Uniform per-partition capacity covering the LARGEST task: shapes
    (and therefore compiled programs) match across tasks and across
    same-parameter submissions, while per-task row counts stay exact."""
    rows = max((_rows(t) for t in tasks), default=1)
    return max(1, -(-max(rows, 1) // max(nparts, 1)))


def _blocks(items: List, k: int) -> List[List]:
    """k contiguous blocks (first blocks take the remainder)."""
    k = max(1, min(k, max(1, len(items))))
    per = -(-len(items) // k)
    return [items[i * per:(i + 1) * per] for i in range(k)]


# -- wordcount ---------------------------------------------------------------

_VOCAB = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
          "theta", "iota", "kappa")


def _choices(seed: int, n: int, k: int) -> "np.ndarray":
    """The first ``n`` values of ``random.Random(seed).choice(range(k))``
    (1 <= k < 2**32), drawn in bulk: numpy's MT19937 starts from the same
    state, and ``choice`` keeps the top ``k.bit_length()`` bits of each
    32-bit draw, rejecting those >= k.  Equal to the JAX package's
    per-word ``rng.choice`` loop (``tests/test_torch_service.py`` holds
    them equal), in a fraction of the time."""
    import numpy as np
    if not 1 <= k < 2**32:
        raise ValueError(f"_choices: k={k} outside [1, 2**32)")
    state = random.Random(seed).getstate()[1]
    rs = np.random.RandomState()
    rs.set_state(("MT19937", np.array(state[:624], dtype=np.uint32),
                  state[624]))
    shift = np.uint32(32 - k.bit_length())
    parts, got = [np.zeros(0, np.uint32)], 0
    while got < n:
        # at least half of the draws are kept: k >= 2**(bits - 1)
        top = rs.randint(0, 2**32, size=(n - got) * 2 + 64,
                         dtype=np.uint32) >> shift
        top = top[top < k]
        parts.append(top)
        got += top.size
    return np.concatenate(parts)[:n]


def _wc_lines(params: dict) -> List[str]:
    lines = params.get("lines")
    if lines is not None:
        return [str(x) for x in lines]
    import numpy as np
    n = int(params.get("n_lines", 512))
    wpl = int(params.get("words_per_line", 6))
    words = np.asarray(_VOCAB, dtype=object)[
        _choices(int(params.get("seed", 0)), n * wpl, len(_VOCAB))]
    return list(map(" ".join, words.reshape(n, wpl).tolist()))


def _wc_tasks(params: dict, nparts: int) -> List[dict]:
    return [{"line": b} for b in _blocks(_wc_lines(params),
                                         int(params.get("n_tasks", 4)))]


def _wc_query(ctx, columns: dict, params: dict, capacity=None):
    from dryad_tpu_torch.apps.wordcount import wordcount_query
    lines = columns["line"]
    wpl = max((len(str(ln).split()) for ln in lines), default=1) or 1
    rows_per_part = capacity or -(-max(len(lines), 1) // ctx.nparts)
    cap = max(256, rows_per_part * (wpl + 2))
    ds = ctx.from_columns(dict(columns), capacity=capacity,
                          str_max_len=64)
    return wordcount_query(ds, tokens_per_partition=cap)


def _wc_combine(tables: List) -> Dict[str, Any]:
    c: Counter = Counter()
    for t in tables:
        if not t:
            continue
        for w, n in zip(t["line"], t["n"]):
            w = w.decode() if isinstance(w, bytes) else str(w)
            if w:
                c[w] += int(n)
    return {"total_words": sum(c.values()), "distinct": len(c),
            "words": dict(sorted(c.items()))}


_register(ServiceApp("wordcount", _wc_tasks, _wc_query, _wc_combine))


# -- groupsum (numeric group-by aggregate; UDF-free, shippable) --------------

def _gs_cols(params: dict) -> Dict[str, List[int]]:
    import numpy as np
    n = int(params.get("n_rows", 4096))
    keys = int(params.get("n_keys", 16))
    rng = np.random.RandomState(int(params.get("seed", 0)))
    return {"k": rng.randint(0, keys, n).astype("int32").tolist(),
            "v": rng.randint(0, 100, n).astype("int32").tolist()}


def _gs_tasks(params: dict, nparts: int) -> List[dict]:
    cols = _gs_cols(params)
    k = int(params.get("n_tasks", 4))
    return [{"k": kb, "v": vb}
            for kb, vb in zip(_blocks(cols["k"], k),
                              _blocks(cols["v"], k))]


def _gs_query(ctx, columns: dict, params: dict, capacity=None):
    import numpy as np
    ds = ctx.from_columns({k: np.asarray(v, dtype=np.int32)
                           for k, v in columns.items()},
                          capacity=capacity)
    return ds.group_by(["k"], {"s": ("sum", "v"),
                               "n": ("count", None)})


def _gs_combine(tables: List) -> Dict[str, Any]:
    sums: Counter = Counter()
    cnt: Counter = Counter()
    for t in tables:
        if not t:
            continue
        for k, s, n in zip(t["k"], t["s"], t["n"]):
            sums[int(k)] += int(s)
            cnt[int(k)] += int(n)
    return {"groups": {str(k): {"sum": sums[k], "count": cnt[k]}
                       for k in sorted(sums)}}


_register(ServiceApp("groupsum", _gs_tasks, _gs_query, _gs_combine))
