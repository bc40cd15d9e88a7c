"""Physical plan (de)serialization — the port of
``dryad_tpu/plan/serialize.py``, the same JSON wire format.

A plan is JSON; Python callables inside ops are serialized as opaque
references (a plan with UDFs round-trips structurally for inspection and
tooling; re-execution re-binds the callables via ``fn_table``), except
the values that implement the shippable-value protocol
(``ship_ref_of``), which cross as data and rebuild themselves.
"""

from __future__ import annotations

import importlib
import json
from typing import Any, Callable, Dict, Optional

from dryad_tpu_torch.plan.stages import Exchange, Leg, Stage, StageGraph, StageOp

__all__ = ["graph_to_json", "graph_from_json", "import_ref",
           "ship_ref_of"]


def import_ref(obj: Any) -> Optional[str]:
    """``module:qualname`` if re-importing it yields the SAME object —
    the importability check of the static analyzer
    (``analysis/udf_lint.shippability_of``) and of the cluster shipper
    still to be ported."""
    mod = getattr(obj, "__module__", None)
    qual = getattr(obj, "__qualname__", None)
    if not mod or not qual or "<" in qual:
        return None
    try:
        o: Any = importlib.import_module(mod)
        for part in qual.split("."):
            o = getattr(o, part)
    except (ImportError, AttributeError):
        return None
    return f"{mod}:{qual}" if o is obj else None


def ship_ref_of(v: Any) -> Optional[str]:
    """Shippable-VALUE protocol: an op-param object that serializes as
    DATA instead of by name.  A value qualifies when it implements
    ``__ship_payload__() -> jsonable`` plus the classmethod
    ``__from_payload__(payload)``, and its class is importable — it
    then crosses the wire as ``{"__shipped__": {cls, payload}}`` and
    rebuilds on the executing side with no fn_table registration.  The
    SQL front end's row-expression programs (``sql/rowexpr.py``) are
    the users: a compiled query's Map/Filter callables are pure data.
    Returns the class's import ref, or None when the protocol is absent
    or unusable."""
    if (not hasattr(v, "__ship_payload__")
            or not hasattr(type(v), "__from_payload__")):
        return None
    return import_ref(type(v))


# params carrying planner-internal mutable state shared between ops of one
# plan (decomposable treedef boxes): contents are rebuilt at trace time on
# the executing side, but IDENTITY must survive — partial and merge stages
# share one box instance
_EPHEMERAL_PARAMS = {"box"}


def _op_to_json(op: StageOp, fn_names: Dict[int, str],
                shared: Dict[int, int]) -> dict:
    def enc(v: Any, pname: str) -> Any:
        if isinstance(v, (str, int, float, bool, type(None))):
            return v
        if id(v) in fn_names:
            # an explicitly registered name (Context(fn_table=)) — covers
            # non-callable values (user Decomposables) too
            return {"__fn__": fn_names[id(v)]}
        ref = ship_ref_of(v)
        if ref is not None:
            # shippable-value protocol: serialize as data, rebuild via
            # the class's __from_payload__ on the executing side
            return {"__shipped__": {"cls": ref,
                                    "payload": v.__ship_payload__()}}
        if callable(v):
            return {"__fn__": fn_names.get(id(v), f"fn_{id(v):x}")}
        if isinstance(v, bytes):
            return {"__bytes__": v.decode("latin1")}
        if pname in _EPHEMERAL_PARAMS and isinstance(v, dict):
            sid = shared.setdefault(id(v), len(shared))
            return {"__ephemeral__": sid}
        if isinstance(v, (tuple, list)):
            return {"__tuple__": [enc(x, pname) for x in v]}
        if isinstance(v, dict):
            try:
                json.dumps(v)
                return {"__dict__": dict(v)}
            except TypeError:
                return {"__dict__": {kk: enc(vv, pname)
                                     for kk, vv in v.items()}}
        # opaque leaf: structurally noted; re-execution re-binds via
        # fn_table like other UDFs
        return {"__opaque__": f"{op.kind}.{pname}"}

    d = {"kind": op.kind,
         "params": {k: enc(v, k) for k, v in op.params.items()}}
    if op.span is not None:
        d["span"] = list(op.span)
    return d


def _op_from_json(d: dict, fn_table: Optional[Dict[str, Callable]],
                  shared: Dict[int, dict]) -> StageOp:
    def dec(v: Any) -> Any:
        if isinstance(v, dict) and "__fn__" in v:
            name = v["__fn__"]
            if fn_table is None or name not in fn_table:
                raise KeyError(
                    f"plan references callable {name!r}; pass it in "
                    f"fn_table")
            return fn_table[name]
        if isinstance(v, dict) and "__bytes__" in v:
            return v["__bytes__"].encode("latin1")
        if isinstance(v, dict) and "__shipped__" in v:
            mod_name, qual = v["__shipped__"]["cls"].split(":", 1)
            cls: Any = importlib.import_module(mod_name)
            for part in qual.split("."):
                cls = getattr(cls, part)
            return cls.__from_payload__(v["__shipped__"]["payload"])
        if isinstance(v, dict) and "__ephemeral__" in v:
            return shared.setdefault(v["__ephemeral__"], {})
        if isinstance(v, dict) and "__opaque__" in v:
            name = v["__opaque__"]
            if fn_table is None or name not in fn_table:
                raise KeyError(
                    f"plan references opaque param {name!r}; pass it in "
                    f"fn_table")
            return fn_table[name]
        if isinstance(v, dict) and "__tuple__" in v:
            return tuple(dec(x) for x in v["__tuple__"])
        if isinstance(v, dict) and "__dict__" in v:
            return {kk: dec(vv) for kk, vv in v["__dict__"].items()}
        if isinstance(v, list):   # legacy tuple-in-dict encoding
            return tuple(dec(x) for x in v)
        return v

    span = tuple(d["span"]) if d.get("span") else None
    return StageOp(d["kind"], {k: dec(v) for k, v in d["params"].items()},
                   span=span)


def graph_to_json(graph: StageGraph,
                  fn_names: Optional[Dict[int, str]] = None) -> str:
    fn_names = fn_names or {}
    shared: Dict[int, int] = {}
    stages = []
    for st in graph.stages:
        legs = []
        for leg in st.legs:
            if isinstance(leg.src, int):
                src: Any = {"stage": leg.src}
            elif leg.src[0] == "placeholder":
                src = {"placeholder": leg.src[1]}
            else:
                src = {"source": True}
            ex = None
            if leg.exchange is not None:
                e = leg.exchange
                ex = {"kind": e.kind, "keys": list(e.keys),
                      "out_capacity": e.out_capacity,
                      "descending": e.descending,
                      "bounds_from": e.bounds_from,
                      "bounds_key": e.bounds_key,
                      "axis": e.axis}
            legs.append({"src": src,
                         "ops": [_op_to_json(o, fn_names, shared)
                                 for o in leg.ops],
                         "exchange": ex})
        sd = {"id": st.id, "label": st.label, "legs": legs,
              "salt_ok": st.salt_ok,
              "body": [_op_to_json(o, fn_names, shared)
                       for o in st.body]}
        # emitted only when set: plans without placement reliance stay
        # byte-identical to the pre-adaptive wire format
        if st.placement_relied:
            sd["placement_relied"] = True
        stages.append(sd)
    return json.dumps({"version": 1, "stages": stages,
                       "out_stage": graph.out_stage}, indent=1)


def graph_from_json(s: str, fn_table: Optional[Dict[str, Callable]] = None,
                    sources: Optional[Dict[int, Any]] = None) -> StageGraph:
    """Rebuild a StageGraph.  ``sources`` maps (stage_id, leg_index) source
    slots — keyed "sid:leg" — to bound data handles."""
    d = json.loads(s)
    shared: Dict[int, dict] = {}
    stages = []
    for sd in d["stages"]:
        legs = []
        for li, ld in enumerate(sd["legs"]):
            src = ld["src"]
            if "stage" in src:
                lsrc: Any = src["stage"]
            elif "placeholder" in src:
                lsrc = ("placeholder", src["placeholder"])
            else:
                key = f"{sd['id']}:{li}"
                if sources is None or key not in sources:
                    raise KeyError(f"plan needs source binding for {key}")
                lsrc = ("source", sources[key])
            ex = None
            if ld["exchange"] is not None:
                e = ld["exchange"]
                ex = Exchange(e["kind"], tuple(e["keys"]), e["out_capacity"],
                              e["descending"], e["bounds_from"],
                              e["bounds_key"], axis=e.get("axis"))
            legs.append(Leg(lsrc, [_op_from_json(o, fn_table, shared)
                                   for o in ld["ops"]], ex))
        stages.append(Stage(id=sd["id"], legs=legs,
                            body=[_op_from_json(o, fn_table, shared)
                                  for o in sd["body"]],
                            label=sd["label"],
                            salt_ok=sd.get("salt_ok", False),
                            placement_relied=sd.get("placement_relied",
                                                    False)))
    return StageGraph(stages, d["out_stage"])
