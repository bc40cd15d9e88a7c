"""Sequential semantics oracle (the reference's LocalDebug mode) — the
port of ``dryad_tpu/oracle.py``.

The reference runs every query twice in its tests — cluster mode and
LINQ-to-objects (``context.LocalDebug = true``,
LinqToDryad/DryadLinqQuery.cs:349) — and compares.  This module is the
port's LINQ-to-objects: a numpy / Python interpreter of the logical
expression DAG with no batches, no partitions and no exchange,
reached through ``Context(local_debug=True)``.

Tables are ``{column: np.ndarray | list[bytes]}``.  User callables are
the port's, written against torch: a Select / Where / FlatMap /
take_while fn gets the numeric columns as torch tensors on the CPU
(string columns as lists of bytes, as the JAX oracle hands them), a
Decomposable's seed one row's columns as CPU tensors, a group_apply fn
one group's columns as CPU tensors, and a device UDF without a
``host_fn`` (``apply_per_partition``, ``cross_apply``) the port's own
Batches on the CPU (``_apply_device_fn``).  Nothing here touches the
card, whatever the Context's device.
"""

from __future__ import annotations

import collections
import functools
from typing import Any, Dict, List

import numpy as np
import torch

from dryad_tpu_torch.data.columnar import (StringColumn, _is_string_list,
                                           batch_from_numpy, batch_to_numpy,
                                           string_column_from_list)
from dryad_tpu_torch.plan import expr as E

__all__ = ["run_oracle"]

Table = Dict[str, Any]  # column name -> np.ndarray | list[bytes]


def _nrows(t: Table) -> int:
    for v in t.values():
        return len(v)
    return 0


def _row(t: Table, i: int):
    return {k: (v[i] if isinstance(v, list) else v[i]) for k, v in t.items()}


def _take_rows(t: Table, idx) -> Table:
    out = {}
    for k, v in t.items():
        if isinstance(v, list):
            out[k] = [v[i] for i in idx]
        else:
            out[k] = np.asarray(v)[idx]
    return out


def _to_np(cols: Table) -> Table:
    """A source's host columns as a table, as ``from_columns`` reads
    them: a list of str or bytes becomes a list of bytes (str as UTF-8),
    anything else a numpy array."""
    return {k: ([x.encode() if isinstance(x, str) else x for x in v]
                if _is_string_list(v, len(v)) else np.asarray(v))
            for k, v in cols.items()}


def _tokenize(line: bytes, delims: bytes, max_len: int, lower: bool):
    out = []
    tok = bytearray()
    for b in line:
        if b in delims:
            if tok:
                out.append(bytes(tok[:max_len]))
                tok = bytearray()
        else:
            tok.append(b)
    if tok:
        out.append(bytes(tok[:max_len]))
    if lower:
        out = [t.lower() for t in out]
    return out


def _np(v):
    """A UDF's output column as the oracle keeps it: a list of bytes
    stays, a tensor or anything else becomes a numpy array."""
    if isinstance(v, list):
        return v
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.asarray(v)


def _to_torch(t: Table) -> Dict[str, Any]:
    """A table as a torch UDF sees it: numeric columns as CPU tensors
    (copies: an in-place op in the UDF must not reach the caller's
    columns or the oracle's memo), string columns as lists of bytes."""
    return {k: v if isinstance(v, list) else torch.from_numpy(np.array(v))
            for k, v in t.items()}


def _apply_device_fn(fn, tables: List[Table], with_index: bool = False
                     ) -> Table:
    """Oracle-side evaluation of a DEVICE UDF (Batch -> Batch) over whole
    tables treated as one partition: build the port's Batches on the CPU
    (``data/columnar.batch_from_numpy``), call the same callable the
    executor calls, and read the valid rows back.  The reference's
    LocalDebug likewise runs the IDENTICAL user lambda
    (DryadLinqQuery.cs:349)."""

    def widest(t: Table) -> int:
        w = 1
        for v in t.values():
            if isinstance(v, list):
                w = max(w, max((len(x) for x in v), default=1))
        return w

    args = [batch_from_numpy(t, str_max_len=widest(t), device="cpu")
            for t in tables]
    if with_index:
        args.append(0)          # the single oracle "partition"
    return {k: _np(v) for k, v in batch_to_numpy(fn(*args)).items()}


def _agg(kind: str, vals: List[Any]):
    if kind == "count":
        return len(vals)
    if kind == "sum":
        return np.sum(vals, axis=0)
    if kind == "min":
        return np.min(vals, axis=0)
    if kind == "max":
        return np.max(vals, axis=0)
    if kind == "mean":
        return np.mean(vals, axis=0)
    if kind == "any":
        return bool(np.any(vals))
    if kind == "all":
        return bool(np.all(vals))
    raise ValueError(kind)


def _eval_decomposable(dec: "E.Decomposable", t: Dict[str, Any],
                       idx: List[int], oname: str) -> Dict[str, Any]:
    """Sequential-reference evaluation of a Decomposable over one group:
    seed each row, left-fold merge, finalize — the same seed / merge /
    finalize callables the kernel runs, on one-row states of CPU
    tensors."""
    # string columns feed seed as 1-row StringColumns, width = the
    # column's widest value so every row state has matching shapes
    widths = {k: max((len(x) for x in v), default=1) or 1
              for k, v in t.items() if isinstance(v, list)}

    def row_state(i):
        cols = {}
        for k, v in t.items():
            if isinstance(v, list):
                cols[k] = string_column_from_list([v[i]], 1, widths[k],
                                                  "cpu")
            else:
                cols[k] = torch.from_numpy(np.array(v[i: i + 1]))
        return dec.seed(cols)

    states = [row_state(i) for i in idx]
    merged = functools.reduce(dec.merge, states)
    val = dec.finalize(merged) if dec.finalize is not None else merged
    named = val if isinstance(val, dict) else {oname: val}
    out = {}
    for k, v in named.items():
        a = _np(v)
        out[k] = a[0] if a.shape and a.shape[0] == 1 else a
    return out


def _key_of(row: dict, keys) -> tuple:
    names = keys if keys else sorted(row.keys())
    out = []
    for k in names:
        v = row[k]
        out.append(v if isinstance(v, bytes) else
                   (v.item() if hasattr(v, "item") else v))
    return tuple(out)


def run_oracle(root: E.Node, bindings: Dict[str, Table] | None = None
               ) -> Table:
    """The table ``root`` evaluates to, sequentially: every Source must
    hold its host table; ``bindings`` maps a do_while placeholder's name
    to the loop-carried table."""
    bindings = bindings or {}
    memo: Dict[int, Table] = {}

    def ev(n: E.Node) -> Table:
        if n.id in memo:
            return memo[n.id]
        t = _ev(n)
        memo[n.id] = t
        return t

    def _ev(n: E.Node) -> Table:
        if isinstance(n, E.Source):
            if n.host is None:
                raise ValueError("Source has no host data for oracle")
            return _to_np(n.host)
        if isinstance(n, E.Placeholder):
            return _to_np(bindings[n.name])
        if isinstance(n, E.Map):
            t = ev(n.parents[0])
            return {k: _np(v) for k, v in n.fn(_to_torch(t)).items()}
        if isinstance(n, E.Filter):
            t = ev(n.parents[0])
            mask = _np(n.fn(_to_torch(t))).astype(bool)
            return _take_rows(t, np.nonzero(mask)[0])
        if isinstance(n, E.FlatTokens):
            t = ev(n.parents[0])
            toks: List[bytes] = []
            for line in t[n.column]:
                toks.extend(_tokenize(line, n.delims, n.max_token_len,
                                      n.lower))
            return {n.column: toks}
        if isinstance(n, E.ApplyPerPartition):
            t = ev(n.parents[0])
            if n.host_fn is not None:
                return {k: _np(v) for k, v in n.host_fn(dict(t)).items()}
            # no host_fn: run the DEVICE fn itself over the whole table
            # as one partition (index 0)
            return _apply_device_fn(n.fn, [t], with_index=n.with_index)
        if isinstance(n, E.FlatMap):
            t = ev(n.parents[0])
            out_cols, mask = n.fn(_to_torch(t))
            mask = _np(mask).astype(bool)
            idx = np.nonzero(mask.reshape(-1))[0]
            out = {}
            for k, v in out_cols.items():
                arr = _np(v)
                flat = arr.reshape((-1,) + arr.shape[2:])
                out[k] = flat[idx]
            return out
        if isinstance(n, E.Zip):
            lt, rt = ev(n.parents[0]), ev(n.parents[1])
            nmin = min(_nrows(lt), _nrows(rt))
            out = {k: (v[:nmin] if isinstance(v, list) else
                       np.asarray(v)[:nmin]) for k, v in lt.items()}
            for k, v in rt.items():
                name = k if k not in out else k + n.suffix
                out[name] = (v[:nmin] if isinstance(v, list)
                             else np.asarray(v)[:nmin])
            return out
        if isinstance(n, E.SlidingWindow):
            t = ev(n.parents[0])
            nrows = _nrows(t)
            nwin = max(0, nrows - n.w + 1)
            out = {}
            for k, v in t.items():
                if isinstance(v, list):
                    out[k] = [[v[i + j] for j in range(n.w)]
                              for i in range(nwin)]
                else:
                    arr = np.asarray(v)
                    out[k] = np.stack([arr[i:i + n.w]
                                       for i in range(nwin)]) if nwin else \
                        np.zeros((0, n.w) + arr.shape[1:], arr.dtype)
            return out
        if isinstance(n, E.WithRowIndex):
            t = ev(n.parents[0])
            out = dict(t)
            out[n.column] = np.arange(_nrows(t), dtype=np.int32)
            return out
        if isinstance(n, E.AssumePartitioning):
            return ev(n.parents[0])
        if isinstance(n, E.SkipTake):
            t = ev(n.parents[0])
            nrows = _nrows(t)
            if n.op == "skip":
                return _take_rows(t, range(min(n.n, nrows), nrows))
            pred = _np(n.fn(_to_torch(t))).astype(bool)
            cut = nrows
            for i in range(nrows):
                if not pred[i]:
                    cut = i
                    break
            if n.op == "take_while":
                return _take_rows(t, range(cut))
            return _take_rows(t, range(cut, nrows))
        if isinstance(n, E.GroupByAgg):
            t = ev(n.parents[0])
            nrows = _nrows(t)
            groups: Dict[tuple, List[int]] = collections.defaultdict(list)
            order: List[tuple] = []
            for i in range(nrows):
                k = _key_of({kk: t[kk][i] for kk in n.keys}, tuple(n.keys))
                if k not in groups:
                    order.append(k)
                groups[k].append(i)
            out: Table = {k: [] for k in n.keys}
            agg_out_names: List[str] = []
            for k in order:
                idx = groups[k]
                for kk, kv in zip(n.keys, k):
                    out[kk].append(kv)
                for oname, spec in n.aggs.items():
                    if isinstance(spec, E.Decomposable):
                        named = _eval_decomposable(spec, t, idx, oname)
                    else:
                        kind, col = spec
                        vals = [t[col][i] for i in idx] if col \
                            else [None] * len(idx)
                        named = {oname: _agg(kind, vals)}
                    for cname, v in named.items():
                        out.setdefault(cname, []).append(v)
                        if cname not in agg_out_names:
                            agg_out_names.append(cname)
            return {k: (v if v and isinstance(v[0], bytes) else np.asarray(v))
                    for k, v in out.items()}
        if isinstance(n, (E.GroupApply, E.GroupTopK, E.GroupRankSelect)):
            t = ev(n.parents[0])
            nrows = _nrows(t)
            groups: Dict[tuple, List[int]] = collections.defaultdict(list)
            order: List[tuple] = []
            for i in range(nrows):
                k = _key_of({kk: t[kk][i] for kk in n.keys}, tuple(n.keys))
                if k not in groups:
                    order.append(k)
                groups[k].append(i)
            if isinstance(n, E.GroupTopK):
                idx: List[int] = []
                for k in order:
                    g = groups[k]
                    # python sorted is stable even with reverse=True, same
                    # as the device's stable inverted-lane lexsort
                    top = sorted(g, key=lambda i: t[n.by][i],
                                 reverse=n.descending)[:n.k]
                    idx.extend(top)
                return _take_rows(t, idx)
            if isinstance(n, E.GroupRankSelect):
                out: Table = {k: [] for k in n.keys}
                oname = n.out or n.by
                out[oname] = []
                for k in order:
                    g = sorted(groups[k], key=lambda i: t[n.by][i])
                    if n.rank == "median":
                        pick = g[(len(g) - 1) // 2]
                    elif n.rank == "min":
                        pick = g[0]
                    else:
                        pick = g[-1]
                    for kk, kv in zip(n.keys, k):
                        out[kk].append(kv)
                    out[oname].append(t[n.by][pick])
                return {k: (v if v and isinstance(v[0], bytes)
                            else np.asarray(v)) for k, v in out.items()}
            # GroupApply: run the SAME fn per group on CPU tensors,
            # padding each group — rows past count are zeros, which fn
            # must not read (the device contract: rows >= count are
            # unspecified).  The device right-sizes group_capacity by
            # measured-need retries, so pad to the largest group.
            C = max([n.group_capacity] + [len(g) for g in groups.values()])
            out_rows: List[Dict[str, Any]] = []
            for k in order:
                g = groups[k]
                cols: Dict[str, Any] = {}
                for kk, v in t.items():
                    if isinstance(v, list):
                        cols[kk] = string_column_from_list(
                            [v[i] for i in g[:C]], C,
                            max([len(b) for b in v] or [1]) or 1, "cpu")
                    else:
                        arr = np.asarray(v)
                        p = np.zeros((C,) + arr.shape[1:], arr.dtype)
                        p[:min(len(g), C)] = arr[g[:C]]
                        cols[kk] = torch.from_numpy(p)
                oc, mask = n.fn(cols, torch.tensor(len(g),
                                                   dtype=torch.int32))
                mask = _np(mask).astype(bool)
                for r in np.nonzero(mask)[0]:
                    row: Dict[str, Any] = {}
                    for kk, kv in zip(n.keys, k):
                        row[kk] = kv
                    for cname, cv in oc.items():
                        if isinstance(cv, StringColumn):
                            d = cv.data[r].numpy()
                            row[cname] = bytes(d[:int(cv.lengths[r])])
                        else:
                            row[cname] = _np(cv)[r]
                    out_rows.append(row)
            if not out_rows:
                names = list(n.keys)
            else:
                names = list(out_rows[0].keys())
            res: Table = {kk: [] for kk in names}
            for row in out_rows:
                for kk in names:
                    res[kk].append(row[kk])
            return {k: (v if v and isinstance(v[0], bytes)
                        else np.asarray(v)) for k, v in res.items()}
        if isinstance(n, E.Join):
            lt, rt = ev(n.parents[0]), ev(n.parents[1])
            rmap: Dict[tuple, List[int]] = collections.defaultdict(list)
            for j in range(_nrows(rt)):
                rmap[_key_of({k: rt[k][j] for k in n.right_keys},
                             tuple(n.right_keys))].append(j)
            rkeyset = set(n.right_keys)
            rextra = [k for k in rt.keys() if k not in rkeyset]
            out_names = list(lt.keys()) + [
                (k if k not in lt else k + "_r") for k in rextra]
            out: Table = {k: [] for k in out_names}
            how = getattr(n, "how", "inner")

            def _zero_of(proto):
                if isinstance(proto, list):
                    return b""
                p = np.asarray(proto)
                return np.zeros((1,) + p.shape[1:], p.dtype)[0]

            matched_right: set = set()
            for i in range(_nrows(lt)):
                k = _key_of({kk: lt[kk][i] for kk in n.left_keys},
                            tuple(n.left_keys))
                matches = rmap.get(k, ())
                matched_right.update(matches)
                for j in matches:
                    for kk in lt.keys():
                        out[kk].append(lt[kk][i])
                    for kk in rextra:
                        name = kk if kk not in lt else kk + "_r"
                        out[name].append(rt[kk][j])
                if how in ("left", "full") and not matches:
                    # unmatched left row: right columns zero-filled
                    for kk in lt.keys():
                        out[kk].append(lt[kk][i])
                    for kk in rextra:
                        name = kk if kk not in lt else kk + "_r"
                        out[name].append(_zero_of(rt[kk]))
            if how in ("right", "full"):
                key_map = dict(zip(n.left_keys, n.right_keys))
                for j in range(_nrows(rt)):
                    if j in matched_right:
                        continue
                    # unmatched right row: left key columns take the right
                    # key values, other left columns zero-filled
                    for kk in lt.keys():
                        if kk in key_map:
                            out[kk].append(rt[key_map[kk]][j])
                        else:
                            out[kk].append(_zero_of(lt[kk]))
                    for kk in rextra:
                        name = kk if kk not in lt else kk + "_r"
                        out[name].append(rt[kk][j])
            return {k: (v if v and isinstance(v[0], bytes) else np.asarray(v))
                    for k, v in out.items()}
        if isinstance(n, E.OrderBy):
            t = ev(n.parents[0])
            nrows = _nrows(t)
            # lexicographic multi-key sort via successive stable sorts from
            # the least significant key (handles bytes descending exactly)
            idx = list(range(nrows))
            for col, desc in reversed(n.keys):
                vals = t[col]
                idx.sort(key=lambda i: vals[i], reverse=desc)
            return _take_rows(t, idx)
        if isinstance(n, E.Distinct):
            t = ev(n.parents[0])
            seen = set()
            idx = []
            keys = tuple(n.keys) or tuple(sorted(t.keys()))
            for i in range(_nrows(t)):
                k = _key_of({kk: t[kk][i] for kk in keys}, keys)
                if k not in seen:
                    seen.add(k)
                    idx.append(i)
            return _take_rows(t, idx)
        if isinstance(n, E.SetOp):
            lt, rt = ev(n.parents[0]), ev(n.parents[1])
            names = list(lt.keys())
            lrows = [_key_of({k: lt[k][i] for k in names}, tuple(names))
                     for i in range(_nrows(lt))]
            rrows = {_key_of({k: rt[k][i] for k in names}, tuple(names))
                     for i in range(_nrows(rt))}
            seen = set()
            idx = []
            for i, k in enumerate(lrows):
                if k in seen:
                    continue
                if n.op == "union":
                    seen.add(k)
                    idx.append(i)
                elif n.op == "intersect" and k in rrows:
                    seen.add(k)
                    idx.append(i)
                elif n.op == "except" and k not in rrows:
                    seen.add(k)
                    idx.append(i)
            out = _take_rows(lt, idx)
            if n.op == "union":
                extra = []
                for i in range(_nrows(rt)):
                    k = _key_of({kk: rt[kk][i] for kk in names}, tuple(names))
                    if k not in seen:
                        seen.add(k)
                        extra.append(i)
                radd = _take_rows(rt, extra)
                out = {k: (list(out[k]) + list(radd[k])
                           if isinstance(out[k], list)
                           else np.concatenate([out[k], radd[k]]))
                       for k in names}
            return out
        if isinstance(n, E.Concat):
            lt, rt = ev(n.parents[0]), ev(n.parents[1])
            return {k: (list(lt[k]) + list(rt[k]) if isinstance(lt[k], list)
                        else np.concatenate([lt[k], rt[k]]))
                    for k in lt.keys()}
        if isinstance(n, (E.HashRepartition, E.RangeRepartition)):
            return ev(n.parents[0])
        if isinstance(n, E.Broadcast):
            t = ev(n.parents[0])
            reps = n.parents[0].npartitions
            return {k: (list(v) * reps if isinstance(v, list)
                        else np.tile(v, (reps,) + (1,) * (v.ndim - 1)))
                    for k, v in t.items()}
        if isinstance(n, E.Take):
            t = ev(n.parents[0])
            return _take_rows(t, range(min(n.n, _nrows(t))))
        if isinstance(n, E.WithCapacity):
            return ev(n.parents[0])
        if isinstance(n, E.CrossApply):
            lt, rt = ev(n.parents[0]), ev(n.parents[1])
            if n.host_fn is not None:
                return {k: _np(v)
                        for k, v in n.host_fn(dict(lt), dict(rt)).items()}
            # no host_fn: the device fn sees (left partition, full right
            # table); with one oracle partition that is exactly (lt, rt)
            return _apply_device_fn(n.fn, [lt, rt])
        raise TypeError(f"oracle: unhandled node {type(n).__name__}")

    return ev(root)
