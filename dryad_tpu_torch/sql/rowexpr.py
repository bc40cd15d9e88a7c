"""Row-expression programs: the SQL front end's compiled callables — the
port of ``dryad_tpu/sql/rowexpr.py``, the same program grammar.

A bound SQL scalar expression compiles to a small JSON program (nested
lists) interpreted over a columns dict.  The SAME callable runs on four
kinds of input:

* CUDA tensors and ``StringColumn``s in the executor,
* meta tensors in the static cost model (``hopper_kernels.shape_only``),
* CPU tensors, with lists of bytes for strings, in the oracle
  (``oracle.run_oracle``),

and the program crosses a plan's JSON AS DATA via the shippable-value
protocol (``plan/serialize.ship_ref_of``).  Every literal row and
constant column is built on its input's device, so a CUDA column never
meets a CPU literal and a meta column stays meta (an exact cost
report).  Arithmetic takes torch's promotion, which for these operands
is ``jnp``'s with x64 off: int32 / int32 is float32, int32 * float32 is
float32, a Python literal is weak.  String equality handles the device
representation (StringColumn byte matrix) and host lists of bytes, and
gives a bool tensor on both.

Program grammar (JSON-able, deterministic)::

    ["col", name]                  column reference (physical name)
    ["lit", value, type]           scalar literal; type "str" encodes
                                   the value utf-8 at eval time
    ["const", value, type]         literal broadcast to a whole column
    ["bin", op, lhs, rhs]          op in + - * / = != < <= > >= and or
    ["not", x] / ["neg", x]
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

__all__ = ["Predicate", "Projector", "render_prog", "prog_columns",
           "fold_prog"]

_DTYPES = {"int": torch.int32, "float": torch.float32, "bool": torch.bool}


def _is_strcol(v: Any) -> bool:
    """Device string column (``data/columnar.StringColumn``,
    duck-typed)."""
    return hasattr(v, "data") and hasattr(v, "lengths")


def _is_host_str(v: Any) -> bool:
    if isinstance(v, (list, tuple)):
        return len(v) == 0 or isinstance(v[0], (bytes, str))
    dt = getattr(v, "dtype", None)
    return isinstance(dt, np.dtype) and dt.kind in ("S", "U", "O")


def _str_eq(a: Any, b: Any):
    """Elementwise string equality across representations; either side
    may be a column (StringColumn / host list) or a bytes literal.  A
    bool tensor on the column's device."""
    if isinstance(a, bytes):
        a, b = b, a
    if _is_strcol(a):
        dev = a.data.device
        if isinstance(b, bytes):
            if len(b) > a.max_len:
                # no stored string can equal a literal longer than the
                # column's max_len — comparing the truncation instead
                # would spuriously match its own prefix
                return torch.zeros(a.lengths.shape, dtype=torch.bool,
                                   device=dev)
            pad = b + b"\x00" * (a.max_len - len(b))
            row = torch.tensor(list(pad), dtype=torch.uint8, device=dev)
            return ((a.lengths == len(b))
                    & (a.data == row[None, :]).all(dim=1))
        # column vs column: compare over the common width, then the
        # longer side's overhang must be empty (padding is zero)
        w = min(a.max_len, b.max_len)
        same = (a.data[:, :w] == b.data[:, :w]).all(dim=1)
        return same & (a.lengths == b.lengths)
    # host representations (oracle): lists / object arrays of bytes

    def norm(x):
        return x if isinstance(x, bytes) else str(x).encode()

    if isinstance(b, bytes):
        eq = [norm(x) == b for x in a]
    else:
        eq = [norm(x) == norm(y) for x, y in zip(a, b)]
    return torch.tensor(eq, dtype=torch.bool)


def _const_like(cols: Dict[str, Any], value: Any, typ: str):
    """A whole column holding ``value``, row-count matched to the batch
    and on its device (the lowering's global-aggregate key, a
    column-free predicate's mask)."""
    v = next(iter(cols.values()))
    if _is_strcol(v):
        n, dev = v.lengths.shape[0], v.lengths.device
    elif isinstance(v, torch.Tensor):
        n, dev = v.shape[0], v.device
    else:                                   # host list / ndarray
        n, dev = len(v), torch.device("cpu")
    return torch.full((n,), value, dtype=_DTYPES.get(typ, torch.int32),
                      device=dev)


def _ev(prog: List, cols: Dict[str, Any]) -> Any:
    head = prog[0]
    if head == "col":
        return cols[prog[1]]
    if head == "lit":
        v, t = prog[1], prog[2]
        return v.encode() if t == "str" else v
    if head == "const":
        return _const_like(cols, prog[1], prog[2])
    if head == "not":
        v = _ev(prog[1], cols)
        # column-free subtrees fold to Python scalars (WHERE NOT(1=1));
        # ~True is -2, not False
        return (not v) if isinstance(v, bool) else ~v
    if head == "neg":
        return -_ev(prog[1], cols)
    if head == "bin":
        op = prog[1]
        a = _ev(prog[2], cols)
        b = _ev(prog[3], cols)
        str_sides = (isinstance(a, bytes) or isinstance(b, bytes)
                     or _is_strcol(a) or _is_strcol(b)
                     or _is_host_str(a) or _is_host_str(b))
        if op == "=":
            return _str_eq(a, b) if str_sides else a == b
        if op == "!=":
            return ~_str_eq(a, b) if str_sides else a != b
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
        if op == "and":
            return a & b
        if op == "or":
            return a | b
    raise ValueError(f"bad row-expression program node {prog!r}")


def render_prog(prog: List) -> str:
    """SQL-ish rendering for EXPLAIN / repr."""
    head = prog[0]
    if head == "col":
        return prog[1]
    if head in ("lit", "const"):
        v = prog[1]
        return f"'{v}'" if prog[2] == "str" else repr(v)
    if head == "not":
        return f"(NOT {render_prog(prog[1])})"
    if head == "neg":
        return f"(-{render_prog(prog[1])})"
    op = prog[1].upper() if prog[1] in ("and", "or") else prog[1]
    return f"({render_prog(prog[2])} {op} {render_prog(prog[3])})"


def prog_columns(prog: List) -> set:
    """Set of physical column names a program reads (dead-column
    pruning + scan-prefix analysis, analysis/canon.py)."""
    head = prog[0]
    if head == "col":
        return {prog[1]}
    if head in ("lit", "const"):
        return set()
    if head in ("not", "neg"):
        return prog_columns(prog[1])
    if head == "bin":
        return prog_columns(prog[2]) | prog_columns(prog[3])
    raise ValueError(f"bad row-expression program node {prog!r}")


def fold_prog(prog: List) -> List:
    """Constant-fold column-free subtrees to ``["lit", v, typ]`` —
    pure data-to-data, mirroring :func:`_ev`'s scalar semantics, so
    the folded program computes the SAME function.  Division by zero
    (and any other eval-time surprise) leaves the subtree unfolded;
    the runtime keeps its behavior."""
    head = prog[0]
    if head in ("col", "lit", "const"):
        return list(prog)
    if head in ("not", "neg"):
        x = fold_prog(prog[1])
        if x[0] == "lit":
            if head == "not":
                return ["lit", not x[1], "bool"]
            return ["lit", -x[1], x[2]]
        return [head, x]
    # head == "bin"
    op = prog[1]
    a, b = fold_prog(prog[2]), fold_prog(prog[3])
    if a[0] == "lit" and b[0] == "lit":
        va, vb = a[1], b[1]
        try:
            v = {"+": lambda: va + vb, "-": lambda: va - vb,
                 "*": lambda: va * vb, "/": lambda: va / vb,
                 "=": lambda: va == vb, "!=": lambda: va != vb,
                 "<": lambda: va < vb, "<=": lambda: va <= vb,
                 ">": lambda: va > vb, ">=": lambda: va >= vb,
                 "and": lambda: bool(va) and bool(vb),
                 "or": lambda: bool(va) or bool(vb)}[op]()
        except (ZeroDivisionError, TypeError):
            return ["bin", op, a, b]
        if op in ("=", "!=", "<", "<=", ">", ">=", "and", "or"):
            return ["lit", bool(v), "bool"]
        typ = ("float" if op == "/" or "float" in (a[2], b[2])
               else a[2])
        return ["lit", v, typ]
    return ["bin", op, a, b]


class _Shippable:
    """Base: the shippable-value protocol (plan/serialize.ship_ref_of).
    Content-identical instances fingerprint identically
    (plan/stages.Stage.fingerprint), so a re-lowered query finds the
    send slots its last run measured."""

    def __ship_payload__(self):
        raise NotImplementedError

    @classmethod
    def __from_payload__(cls, payload):
        raise NotImplementedError

    def __eq__(self, other):
        return (type(other) is type(self)
                and other.__ship_payload__() == self.__ship_payload__())

    def __hash__(self):
        import json
        return hash(json.dumps(self.__ship_payload__(), sort_keys=True))


class Predicate(_Shippable):
    """Boolean row filter: ``Predicate(prog)(cols) -> bool mask``."""

    def __init__(self, prog: List):
        self.prog = list(prog)

    def __call__(self, cols: Dict[str, Any]):
        mask = _ev(self.prog, cols)
        if isinstance(mask, (bool, int)):
            # column-free predicate (WHERE 1 = 1): broadcast the
            # scalar verdict to a whole mask column
            return _const_like(cols, bool(mask), "bool")
        if isinstance(mask, torch.Tensor):
            return mask if mask.dtype == torch.bool \
                else mask.to(torch.bool)
        return np.asarray(mask).astype(bool)

    def __ship_payload__(self):
        return {"prog": self.prog}

    @classmethod
    def __from_payload__(cls, payload):
        return cls(payload["prog"])

    def __repr__(self):
        return f"sql:{render_prog(self.prog)}"


class Projector(_Shippable):
    """Columnwise projection: ``Projector({out: prog})(cols) -> cols``.
    Plain ``["col", name]`` programs pass the column object through
    untouched (renames are free — string columns included)."""

    def __init__(self, outputs: Dict[str, List]):
        self.outputs = dict(outputs)

    def __call__(self, cols: Dict[str, Any]) -> Dict[str, Any]:
        return {name: _ev(prog, cols)
                for name, prog in self.outputs.items()}

    def __ship_payload__(self):
        return {"outputs": self.outputs}

    @classmethod
    def __from_payload__(cls, payload):
        return cls(payload["outputs"])

    def __repr__(self):
        inner = ", ".join(f"{render_prog(p)} AS {n}"
                          for n, p in self.outputs.items())
        return f"sql:[{inner}]"
