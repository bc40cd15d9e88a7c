"""Plan shipping — the port of ``dryad_tpu/runtime/shiplan.py``: turn a
planned StageGraph into (JSON plan, source specs) that a worker process
rebuilds.

A callable inside a plan op crosses a serialized plan by name: an
importable ``module:qualname``, or a name registered with
``register_fn_table`` (and exported by a worker ``--fn-module``'s
``FN_TABLE``); a value with the shippable-value protocol
(``plan/serialize.ship_ref_of``, the SQL row expressions) crosses as
data.  ``_collect_refs`` names every such value of a graph (the
service's plan cache serializes with it), ``serialize_for_cluster``
adds the deferred sources' specs, and ``resolve_fn_table`` maps a plan
JSON's names back to callables.  It resolves refs into this package
(``dryad_tpu_torch...``), into the ``fn_modules`` themselves and the
names of their ``FN_TABLE`` only: a plan naming any other module (the
JAX package's among them) is refused with DTA905 rather than imported.
"""

from __future__ import annotations

import importlib
import json
from typing import Any, Callable, Dict, Iterable, Tuple

from dryad_tpu_torch.analysis.diagnostics import DiagnosticError
from dryad_tpu_torch.plan.serialize import (graph_to_json, import_ref,
                                            ship_ref_of)
from dryad_tpu_torch.plan.stages import StageGraph
from dryad_tpu_torch.runtime.sources import DeferredSource

__all__ = ["PlanShipError", "serialize_for_cluster", "register_fn_table",
           "resolve_fn_table"]

_PKG = __name__.split(".")[0]


class PlanShipError(DiagnosticError):
    """A shipping-contract violation, carrying the code of the analyzer
    rule that catches it before submission (DTA014 / DTA015 / DTA016;
    DTA905 is the resolving side's)."""


# process-wide shipping names: library code registers its UDFs once
_GLOBAL_FN_TABLE: Dict[str, Any] = {}


def register_fn_table(table: Dict[str, Any]) -> None:
    """Register callables / Decomposables by shipping name for every
    later serialization in this process."""
    _GLOBAL_FN_TABLE.update(table)


# serializer-ephemeral params (rebuilt on the executing side) need no refs
_EPHEMERAL_PARAMS = {"box"}


def _collect_refs(graph: StageGraph,
                  user_names: Dict[int, str]) -> Dict[int, str]:
    """id(value) -> shipping name for every non-JSON value reachable from
    the graph's op params (into dicts, tuples and lists), from
    ``user_names`` (id -> registered name) or the value's import ref.
    Raises PlanShipError (DTA014) for a callable that is not importable
    (a lambda, a closure) and (DTA016) for any other value that does not
    serialize."""
    fn_names: Dict[int, str] = {}

    def visit(v: Any, op, pname: str) -> None:
        if isinstance(v, (str, int, float, bool, bytes, type(None))):
            return
        if id(v) in user_names:
            fn_names[id(v)] = user_names[id(v)]
            return
        if ship_ref_of(v) is not None:
            return                # serializes as data, no name needed
        if callable(v):
            ref = import_ref(v)
            if ref is None:
                code_obj = getattr(v, "__code__", None)
                defined = (f", defined at {code_obj.co_filename}:"
                           f"{code_obj.co_firstlineno}"
                           if code_obj is not None else "")
                raise PlanShipError(
                    f"op {op.kind!r} param {pname!r}: callable "
                    f"{getattr(v, '__qualname__', v)!r}{defined} is not "
                    f"importable (lambda/closure?) — move it to module "
                    f"level, or register it by name via "
                    f"runtime.shiplan.register_fn_table({{name: fn}})",
                    code="DTA014", span=op.span)
            fn_names[id(v)] = ref
            return
        if isinstance(v, (tuple, list)):
            for x in v:
                visit(x, op, pname)
            return
        if isinstance(v, dict):
            for x in v.values():
                visit(x, op, pname)
            return
        raise PlanShipError(
            f"op {op.kind!r} param {pname!r} ({type(v).__name__}) is not "
            f"serializable — register it by name via "
            f"runtime.shiplan.register_fn_table({{name: value}})",
            code="DTA016", span=op.span)

    for st in graph.stages:
        ops = [o for leg in st.legs for o in leg.ops] + list(st.body)
        for op in ops:
            for k, v in op.params.items():
                if k not in _EPHEMERAL_PARAMS:
                    visit(v, op, k)
    return fn_names


def serialize_for_cluster(graph: StageGraph,
                          user_fn_table: Dict[str, Any] | None = None
                          ) -> Tuple[str, Dict[str, Dict[str, Any]]]:
    """(plan_json, source specs keyed "sid:leg").  Every source leg must
    be a ``DeferredSource`` (a cluster Context's constructors make them):
    anything else is DTA015."""
    merged = dict(_GLOBAL_FN_TABLE)
    merged.update(user_fn_table or {})
    user_names = {id(v): k for k, v in merged.items()}
    plan_json = graph_to_json(graph, _collect_refs(graph, user_names))
    specs: Dict[str, Dict[str, Any]] = {}
    for st in graph.stages:
        for li, leg in enumerate(st.legs):
            if isinstance(leg.src, tuple) and leg.src[0] == "source":
                v = leg.src[1]
                if not isinstance(v, DeferredSource):
                    span = next((o.span for o in leg.ops
                                 if o.span is not None), None)
                    raise PlanShipError(
                        "cluster execution needs deferred sources — create "
                        "datasets through a Context constructed with "
                        "cluster=...", code="DTA015", span=span)
                specs[f"{st.id}:{li}"] = v.spec
    return plan_json, specs


def _scan_names(plan_json: str) -> Iterable[str]:
    """Every ``__fn__`` / ``__opaque__`` name in a plan JSON's op
    params."""
    def walk(v):
        if isinstance(v, dict):
            if "__fn__" in v:
                yield v["__fn__"]
            if "__opaque__" in v:
                yield v["__opaque__"]
            for x in v.values():
                yield from walk(x)
        elif isinstance(v, list):
            for x in v:
                yield from walk(x)

    d = json.loads(plan_json)
    for st in d["stages"]:
        ops = [o for leg in st["legs"] for o in leg["ops"]] + st["body"]
        for op in ops:
            yield from walk(op["params"])


def resolve_fn_table(plan_json: str,
                     fn_modules: Iterable[str] = ()) -> Dict[str, Callable]:
    """name -> callable for every name the plan references: the
    ``FN_TABLE`` of each of ``fn_modules``, then ``module:qualname``
    refs into ``dryad_tpu_torch`` or into one of ``fn_modules`` (a
    worker's ``--fn-module``, already imported).  Any other name raises
    PlanShipError (DTA905)."""
    fn_modules = list(fn_modules)
    table: Dict[str, Any] = {}
    for m in fn_modules:
        table.update(getattr(importlib.import_module(m), "FN_TABLE", {}))
    for name in _scan_names(plan_json):
        if name in table:
            continue
        mod_name, sep, qual = name.partition(":")
        if not sep or (mod_name.split(".")[0] != _PKG
                       and mod_name not in fn_modules):
            raise PlanShipError(
                f"plan references {name!r}, which is neither a "
                f"{_PKG} ref nor an fn module's (its FN_TABLE or its "
                f"module:qualname)", code="DTA905")
        obj: Any = importlib.import_module(mod_name)
        for part in qual.split("."):
            obj = getattr(obj, part)
        table[name] = obj
    return table
