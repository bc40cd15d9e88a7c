"""Physical plan: a DAG of stages — the port of
``dryad_tpu/plan/stages.py``.

A stage is one or more legs (a source, local ops, an optional exchange)
and body ops after the exchange.  The JAX package runs a stage as one
jit(shard_map) program over the mesh; the port's executor runs the same
structure as a loop over the logical partitions of one device around a
batched exchange.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

__all__ = ["StageOp", "Exchange", "Leg", "Stage", "StageGraph"]


@dataclasses.dataclass
class StageOp:
    """One fused local operator; params are kind-specific (see
    exec.executor._apply_op)."""

    kind: str
    params: Dict[str, Any]


@dataclasses.dataclass
class Exchange:
    """Repartition at a leg boundary (kind hash | range).  out_capacity is
    resolved by the planner and scaled by the executor on overflow.  A
    range exchange splits on bounds sampled from stage ``bounds_from``'s
    output column ``bounds_key``; ``descending`` reverses the partition
    order."""

    kind: str
    keys: tuple = ()
    out_capacity: int = 0
    descending: bool = False
    bounds_from: Optional[int] = None
    bounds_key: Optional[str] = None


@dataclasses.dataclass
class Leg:
    """One input arm of a stage: source stage (or bound source data),
    local ops before the exchange, optional exchange."""

    src: Any  # int stage id | ("source", data) | ("placeholder", name)
    ops: List[StageOp] = dataclasses.field(default_factory=list)
    exchange: Optional[Exchange] = None


@dataclasses.dataclass
class Stage:
    id: int
    legs: List[Leg]
    body: List[StageOp] = dataclasses.field(default_factory=list)
    label: str = ""
    _capacity_scale: int = 1
    # send-slot slack factor for exchanges (C = ceil(slack*cap/D)); None =
    # JobConfig.initial_send_slack
    _send_slack: Optional[int] = None
    # True when a later lowering elided an exchange by trusting this
    # stage's output placement (the planner's placement_dependent
    # closure): nothing may change where its rows land
    placement_relied: bool = False
    # True when the executor MAY rewrite this stage's exchanges into the
    # hot-key-salted form on skew overflow: a two-hash-exchange
    # inner/left join whose output placement no downstream stage assumed
    # (the planner clears it wherever partition elimination relied on
    # the claim)
    salt_ok: bool = False
    # executor runtime state: the stage ran salted, and stays salted in
    # later runs of the same plan (sticky)
    _salted: bool = False

    def fingerprint(self) -> str:
        """Structural identity: the legs' ops and exchanges and the body
        ops, callables by object id (a fresh lambda is another stage).
        The executor keys each exchange's measured send-slot feedback by
        (fingerprint, leg index), so a re-planned identical query or a
        do_while body's next superstep finds the slots the last run
        measured."""

        def val_fp(v) -> str:
            return "fn%x" % id(v) if callable(v) else repr(v)

        def op_fp(op: StageOp) -> str:
            items = [f"{k}={val_fp(op.params[k])}" for k in sorted(op.params)]
            return f"{op.kind}({','.join(items)})"

        def ex_fp(ex: Optional[Exchange]) -> str:
            if ex is None:
                return "-"
            return (f"{ex.kind}[{','.join(ex.keys)}]cap{ex.out_capacity}"
                    f"{'desc' if ex.descending else ''}"
                    f"{ex.bounds_key or ''}")

        legs = ";".join(
            ",".join(op_fp(o) for o in leg.ops) + "=>" + ex_fp(leg.exchange)
            for leg in self.legs)
        body = ",".join(op_fp(o) for o in self.body)
        return f"legs:{legs}|body:{body}"


@dataclasses.dataclass
class StageGraph:
    stages: List[Stage]
    out_stage: int

    def topo_order(self) -> List[Stage]:
        # stages are created in topo order by the planner
        return self.stages

    def explain(self) -> str:
        """Plan pretty-printer, in the JAX package's format."""
        lines = []
        for st in self.stages:
            srcs = []
            for leg in st.legs:
                if isinstance(leg.src, int):
                    s = f"stage{leg.src}"
                elif leg.src[0] == "placeholder":
                    s = f"placeholder:{leg.src[1]}"
                else:
                    s = "source"
                ops = ",".join(o.kind for o in leg.ops) or "-"
                ex = ""
                if leg.exchange:
                    ex = (f" =>{leg.exchange.kind}"
                          f"({','.join(leg.exchange.keys)})")
                srcs.append(f"{s}[{ops}{ex}]")
            body = ",".join(o.kind for o in st.body) or "-"
            lines.append(f"stage{st.id} <{st.label}> legs: " +
                         " + ".join(srcs) + f" body: {body}")
        lines.append(f"output: stage{self.out_stage}")
        return "\n".join(lines)
