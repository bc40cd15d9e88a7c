"""Plan verifier: structural rules over the logical Node DAG — the port
of ``dryad_tpu/analysis/plan_rules.py``.

``check_plan`` walks the ``plan/expr.py`` DAG before anything runs and
reports ALL findings in one DiagnosticReport: the errors a cluster
submission would raise one at a time (unshippable UDFs, sources and
params, streamed-plan restrictions) plus hazards no runtime check
catches (redundant exchanges, unsound assume_* claims, pinned
placements, nondeterministic UDFs).  Each rule carries the stable code of
the JAX package's rule, and the code sets (``STATIC_RULE_CODES``,
``diagnostics.RUNTIME_ONLY_CODES``) are the JAX package's.  The
cluster-only rules run with ``cluster=True``; the port has no cluster
runtime yet, so ``fn_table`` is the only registry of shipping names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from dryad_tpu_torch.analysis.diagnostics import (Diagnostic, DiagnosticReport,
                                            Span)
from dryad_tpu_torch.analysis.udf_lint import (fn_def_site, lint_udf,
                                         shippability_of)
from dryad_tpu_torch.plan import expr as E

__all__ = ["check_plan", "RULES", "STATIC_RULE_CODES", "PlanCheck"]


# op kinds a streamed CLUSTER plan cannot run, with the reason (the JAX
# package's runtime/stream_plan._UNSUPPORTED: empty — every operator
# streams — but the rule stays so an entry is caught statically)
_UNSUPPORTED: Dict[str, str] = {}


def _is_stream_source(data: Any) -> bool:
    """Stream sources by duck type: a StreamSource wraps a ChunkSource as
    ``.cs``; a cluster stream is a deferred source whose spec kind is
    "store_stream"."""
    spec = getattr(data, "spec", None)
    if isinstance(spec, dict) and spec.get("kind") == "store_stream":
        return True
    return getattr(data, "cs", None) is not None


def _is_deferred_source(data: Any) -> bool:
    return isinstance(getattr(data, "spec", None), dict)


def _node_label(n: E.Node) -> str:
    label = getattr(n, "label", "")
    t = type(n).__name__
    return f"{t}:{label}" if label and label != t.lower() else t


class PlanCheck:
    """Shared state one check pass's rules read: the walked DAG, consumer
    counts, stream-source presence, and the cluster-target flag."""

    def __init__(self, root: E.Node, cluster: bool = False,
                 fn_table: Optional[Dict[str, Any]] = None):
        self.root = root
        self.nodes: List[E.Node] = E.walk(root)
        self.cluster = bool(cluster)
        self.fn_table = dict(fn_table or {})
        self.registered_ids: Set[int] = {id(v)
                                         for v in self.fn_table.values()}
        self.consumers: Dict[int, int] = {}
        for n in self.nodes:
            for p in n.parents:
                self.consumers[p.id] = self.consumers.get(p.id, 0) + 1
        self.has_stream = any(
            isinstance(n, E.Source) and _is_stream_source(n.data)
            for n in self.nodes)
        # nodes with a WithCapacity descendant (transitive) — the
        # capacity-hazard rule keys off this
        self.capped: Set[int] = set()
        capped_frontier = [n for n in self.nodes
                           if isinstance(n, E.WithCapacity)]
        seen: Set[int] = set()
        while capped_frontier:
            n = capped_frontier.pop()
            if n.id in seen:
                continue
            seen.add(n.id)
            self.capped.add(n.id)
            capped_frontier.extend(n.parents)

    def udf_fields(self) -> List[Tuple[E.Node, str, Callable, bool]]:
        """(node, role, callable, ships) for every user callable reachable
        from the DAG.  ``ships`` marks the ones a cluster submission
        ships by reference: ``host_fn`` (oracle-only) and Decomposable
        members (shipped via their registered parent object) never do."""
        out: List[Tuple[E.Node, str, Callable, bool]] = []
        for n in self.nodes:
            fn = getattr(n, "fn", None)
            if callable(fn):
                out.append((n, f"{_node_label(n)}.fn", fn, True))
            host_fn = getattr(n, "host_fn", None)
            if callable(host_fn):
                out.append((n, f"{_node_label(n)}.host_fn", host_fn,
                            False))
            if isinstance(n, E.GroupByAgg):
                for name, spec in n.aggs.items():
                    if isinstance(spec, E.Decomposable):
                        for part in ("seed", "merge", "finalize"):
                            pfn = getattr(spec, part)
                            if callable(pfn):
                                out.append((n, f"agg {name}.{part}", pfn,
                                            False))
        return out


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    name: str
    fn: Callable[[PlanCheck], List[Diagnostic]]


def _span(n: E.Node) -> Optional[Span]:
    return Span.of(getattr(n, "span", None))


# ---------------------------------------------------------------------------
# stream-mode rules (DTA001, global take over cluster streams, is
# RETIRED: the streamed runtime lowers it)


def _rule_stream_placeholder(c: PlanCheck) -> List[Diagnostic]:
    if not (c.cluster and c.has_stream):
        return []
    out = []
    for n in c.nodes:
        if isinstance(n, E.Placeholder):
            out.append(Diagnostic(
                "DTA002", "error",
                f"placeholder {n.name!r} in a streamed cluster plan — "
                f"do_while ships loop state as residents; a streamed "
                f"pipeline cannot be a loop body input",
                _span(n), _node_label(n)))
    return out


# logical node types -> the physical op kind their lowering emits (the
# kind checked against _UNSUPPORTED)
_NODE_OP_KINDS = {
    E.Map: "fn", E.Filter: "filter", E.FlatTokens: "flat_tokens",
    E.FlatMap: "flat_map", E.ApplyPerPartition: "apply",
    E.GroupByAgg: "group", E.GroupApply: "group_apply",
    E.GroupTopK: "group_top_k", E.GroupRankSelect: "group_rank",
    E.Join: "join", E.OrderBy: "sort", E.Distinct: "distinct",
    E.Concat: "concat", E.Zip: "zip", E.SlidingWindow: "sliding_window",
    E.WithRowIndex: "row_index", E.WithCapacity: "recap",
    E.CrossApply: "apply2",
}


def _rule_stream_unsupported(c: PlanCheck) -> List[Diagnostic]:
    """Ops listed in ``_UNSUPPORTED`` over cluster streams (empty today:
    every operator streams)."""
    if not (c.cluster and c.has_stream):
        return []
    if not _UNSUPPORTED:
        return []
    out = []
    for n in c.nodes:
        kind = _NODE_OP_KINDS.get(type(n))
        if kind in _UNSUPPORTED:
            out.append(Diagnostic(
                "DTA003", "error",
                f"op {kind!r} is not supported over cluster streams: "
                f"{_UNSUPPORTED[kind]}", _span(n), _node_label(n)))
    return out


# ---------------------------------------------------------------------------
# hazard rules — contracts the runtime never checks


def _rule_capacity_hazard(c: PlanCheck) -> List[Diagnostic]:
    """DTA010, severity by whether the runtime can right-size the hazard
    from MEASUREMENT: a non-broadcast join's legs are hash exchanges,
    eligible for the measured send slots (the slot probe and the per-leg
    slot feedback, exec/executor.py), and any fan-out op inside a
    do_while body re-runs with measured needs after the first pass, so
    the analyzer says info there.  First-pass-only hazards (flat_map /
    cross_apply / broadcast join in a one-shot job) keep warn: their only
    escape is the overflow-retry ladder."""
    has_loop = any(isinstance(n, E.Placeholder) for n in c.nodes)
    out = []
    for n in c.nodes:
        if not isinstance(n, (E.FlatMap, E.CrossApply, E.Join)):
            continue
        if n.id in c.capped:
            continue
        what = {E.FlatMap: "flat_map output capacity is a static guess",
                E.CrossApply: "cross_apply output rides the left "
                              "capacity",
                E.Join: "join output capacity is expansion x left "
                        "capacity"}[type(n)]
        measured = has_loop or (isinstance(n, E.Join)
                                and not n.broadcast_right)
        sev = "info" if measured else "warn"
        note = (" (measured-slot feedback right-sizes this leg after "
                "the first wave)" if measured else "")
        out.append(Diagnostic(
            "DTA010", sev,
            f"{what}; overflow triggers measured capacity retries — "
            f"bound it with .with_capacity() when the fan-out is known "
            f"(required inside do_while bodies)" + note,
            _span(n), _node_label(n)))
    return out


def _rule_redundant_exchange(c: PlanCheck) -> List[Diagnostic]:
    out = []
    for n in c.nodes:
        if isinstance(n, E.HashRepartition):
            want = E.Partitioning("hash", tuple(n.keys))
        elif isinstance(n, E.RangeRepartition):
            want = E.Partitioning("range", tuple(n.keys))
        else:
            continue
        have = n.parents[0].partitioning
        if have == want:
            out.append(Diagnostic(
                "DTA011", "warn",
                f"redundant {have.kind} repartition on "
                f"{', '.join(want.keys)}: the input already carries this "
                f"placement — the exchange moves every row for nothing",
                _span(n), _node_label(n)))
    return out


def _rule_tee_without_cache(c: PlanCheck) -> List[Diagnostic]:
    out = []
    for n in c.nodes:
        if c.consumers.get(n.id, 0) <= 1 or isinstance(n, E.Source):
            continue
        out.append(Diagnostic(
            "DTA012", "info",
            f"consumed by {c.consumers[n.id]} downstream branches: the "
            f"planner materializes it once per query (Tee), but separate "
            f"queries recompute it — .cache() if reused across terminals "
            f"or do_while iterations", _span(n), _node_label(n)))
    return out


def _rule_unsound_assume(c: PlanCheck) -> List[Diagnostic]:
    out = []
    for n in c.nodes:
        if not isinstance(n, E.AssumePartitioning):
            continue
        have = n.parents[0].partitioning
        claim = E.Partitioning(n.kind, tuple(n.keys))
        if have.kind != "none" and have != claim:
            out.append(Diagnostic(
                "DTA013", "warn",
                f"assume_{n.kind}_partition({', '.join(n.keys)}) "
                f"contradicts the input's known placement "
                f"{have.kind}({', '.join(have.keys)}) — downstream "
                f"shuffle elimination will trust the claim and silently "
                f"mis-group if it is wrong", _span(n), _node_label(n)))
        if not n.keys and n.kind in ("hash", "range"):
            out.append(Diagnostic(
                "DTA013", "warn",
                f"assume_{n.kind}_partition with no keys claims nothing "
                f"a lowering can use", _span(n), _node_label(n)))
    return out


_PINNING_NODES = (E.AssumePartitioning, E.HashRepartition,
                  E.RangeRepartition)


def _pinning_ancestor(n: E.Node, claim) -> Optional[E.Node]:
    """Walk the primary-parent chain while it carries ``claim``
    unchanged; return the assume_*/repartition node the claim
    originates from, or None when it arose naturally (e.g. a group_by
    output's placement)."""
    cur = n
    for _ in range(10_000):           # cycle guard (DAGs only, but cheap)
        if isinstance(cur, _PINNING_NODES):
            return cur
        if not cur.parents:
            return None
        nxt = cur.parents[0]
        if nxt.partitioning != claim:
            return None
        cur = nxt
    return None


def _rule_pinned_partitioning(c: PlanCheck) -> List[Diagnostic]:
    """DTA017: an assume_*/explicit repartition pins the placement a
    downstream consumer's exchange elimination trusts — the planner
    emits no exchange there and marks the chain placement-dependent, so
    adaptive execution (JobConfig.adaptive) has nothing left to
    repartition, salt, or right-size if that consumer skews.  The span
    points at the PINNING op (the thing to relax), not the consumer."""
    out = []
    for n in c.nodes:
        # (parent, the claim whose match makes the planner elide that
        # consumer's exchange) — hash claims for the co-location family,
        # range claims for ascending prefix sorts (planner.py OrderBy)
        sides: List[Tuple[E.Node, E.Partitioning]] = []
        if isinstance(n, (E.GroupByAgg, E.GroupApply, E.GroupTopK,
                          E.GroupRankSelect, E.Distinct)):
            if tuple(n.keys):
                sides = [(n.parents[0],
                          E.Partitioning("hash", tuple(n.keys)))]
        elif isinstance(n, E.Join):
            if n.broadcast_right:
                # broadcast joins never consult the placement claims:
                # lex is dropped and rex replicates regardless, so no
                # exchange elision happens for a pin to block
                continue
            sides = [(n.parents[0],
                      E.Partitioning("hash", tuple(n.left_keys))),
                     (n.parents[1],
                      E.Partitioning("hash", tuple(n.right_keys)))]
        elif isinstance(n, E.OrderBy):
            have = n.parents[0].partitioning
            sort_keys = tuple(k for k, _ in n.keys)
            if (have.kind == "range" and have.keys
                    and all(not d for _, d in n.keys)
                    and sort_keys == have.keys[:len(sort_keys)]):
                sides = [(n.parents[0], have)]
        if not sides:
            continue
        for parent, claim in sides:
            if not claim.keys or parent.partitioning != claim:
                continue           # no elision -> nothing pinned
            keys = claim.keys
            pin = _pinning_ancestor(parent, claim)
            if pin is None:
                continue
            what = (f"assume_{pin.kind}_partition"
                    if isinstance(pin, E.AssumePartitioning)
                    else ("hash_partition"
                          if isinstance(pin, E.HashRepartition)
                          else "range_partition"))
            out.append(Diagnostic(
                "DTA017", "warn",
                f"{what}({', '.join(keys)}) pins the placement "
                f"{_node_label(n)} relies on: the planner elides that "
                f"consumer's exchange, so adaptive execution cannot "
                f"repartition, salt, or right-size it under skew — drop "
                f"the pin (let the consumer own its exchange) if the "
                f"key distribution is not known to be balanced",
                _span(pin), _node_label(pin)))
    return out


# ---------------------------------------------------------------------------
# shippability rules (cluster submissions)


def _rule_ship_udfs(c: PlanCheck) -> List[Diagnostic]:
    if not c.cluster:
        return []
    out = []
    seen: Set[int] = set()
    for n, role, fn, ships in c.udf_fields():
        if not ships or id(fn) in c.registered_ids or id(fn) in seen:
            continue
        why = shippability_of(fn)
        if why is None:
            continue
        seen.add(id(fn))
        site = fn_def_site(fn)
        out.append(Diagnostic(
            "DTA014", "error", f"{role}: {why}",
            site or _span(n), _node_label(n)))
    return out


def _rule_ship_sources(c: PlanCheck) -> List[Diagnostic]:
    if not c.cluster:
        return []
    out = []
    for n in c.nodes:
        if isinstance(n, E.Source) and n.data is not None \
                and not _is_deferred_source(n.data):
            out.append(Diagnostic(
                "DTA015", "error",
                "cluster execution needs deferred sources — create "
                "datasets through a Context constructed with cluster=...",
                _span(n), _node_label(n)))
    return out


def _rule_ship_params(c: PlanCheck) -> List[Diagnostic]:
    """Non-callable op params that cannot ship: user Decomposable
    aggregates must be registered by name."""
    if not c.cluster:
        return []
    out = []
    for n in c.nodes:
        if not isinstance(n, E.GroupByAgg):
            continue
        for name, spec in n.aggs.items():
            if isinstance(spec, E.Decomposable) \
                    and id(spec) not in c.registered_ids:
                out.append(Diagnostic(
                    "DTA016", "error",
                    f"agg {name!r}: Decomposable is not serializable for "
                    f"cluster execution — register it by name in "
                    f"Context(fn_table=...)", _span(n), _node_label(n)))
    return out


# ---------------------------------------------------------------------------
# UDF determinism lint (DTA10x) — applied to every reachable callable


def _rule_udf_determinism(c: PlanCheck) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    linted: Set[int] = set()
    for n, role, fn, _ships in c.udf_fields():
        if id(fn) in linted:
            continue
        linted.add(id(fn))
        out.extend(lint_udf(fn, role=role))
    return out


RULES: List[Rule] = [
    Rule("DTA002", "stream-placeholder", _rule_stream_placeholder),
    Rule("DTA003", "stream-unsupported-op", _rule_stream_unsupported),
    Rule("DTA010", "capacity-hazard", _rule_capacity_hazard),
    Rule("DTA011", "redundant-exchange", _rule_redundant_exchange),
    Rule("DTA012", "tee-without-cache", _rule_tee_without_cache),
    Rule("DTA013", "unsound-assume", _rule_unsound_assume),
    Rule("DTA014", "udf-not-shippable", _rule_ship_udfs),
    Rule("DTA015", "source-not-shippable", _rule_ship_sources),
    Rule("DTA016", "param-not-serializable", _rule_ship_params),
    Rule("DTA017", "pinned-partitioning", _rule_pinned_partitioning),
    # the UDF determinism rule fans out to DTA101..DTA104
    Rule("DTA101", "udf-determinism", _rule_udf_determinism),
]

# codes a static rule can emit (with diagnostics.RUNTIME_ONLY_CODES, the
# JAX package's sets)
STATIC_RULE_CODES = frozenset(
    {r.code for r in RULES} | {"DTA102", "DTA103", "DTA104", "DTA105"})


def check_plan(root: E.Node, cluster: bool = False,
               fn_table: Optional[Dict[str, Any]] = None
               ) -> DiagnosticReport:
    """Run every rule over the DAG rooted at ``root``; returns ALL
    findings at once.  ``cluster`` turns on the shippability family and
    the cluster-stream rules; ``fn_table`` names callables that are
    registered for shipping."""
    check = PlanCheck(root, cluster=cluster, fn_table=fn_table)
    report = DiagnosticReport()
    for rule in RULES:
        report.diagnostics.extend(rule.fn(check))
    # identical findings reached via several Tee'd consumer paths (e.g.
    # a pinned repartition feeding two group_bys) collapse to one record
    # with a consumer count
    return report.dedup()
