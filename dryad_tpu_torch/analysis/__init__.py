"""Pre-submit static analysis — the port of ``dryad_tpu/analysis``: the
plan verifier and the UDF determinism lint (``plan_rules.py``,
``udf_lint.py``), the diagnostics (``diagnostics.py``), the static
cost model (``domain.py``, ``cost.py``) and plan equivalence
(``canon.py``, ``subsume.py``).  Entry points:

* ``Dataset.check()`` / ``Dataset.explain(verify=True)`` — interactive
* ``JobConfig.lint = "warn" | "error"`` — the pre-submit gate of every
  in-memory and streamed submission (``lint_finding`` and
  ``cost_report`` events; "error" blocks the job with ``LintError``)
* ``python -m dryad_tpu_torch.analysis plan.json [--cost]`` — lint a
  serialized plan offline (``check_plan_json``); ``--selfcheck`` lints
  the analyzer itself against the committed docs and goldens
"""

from dryad_tpu_torch.analysis.canon import (  # noqa: F401
    canon_prog, canonical_form_json, canonical_select, conjuncts_of,
    dag_fingerprints, node_fingerprint, scan_prefix,
    semantic_fingerprint)

from dryad_tpu_torch.analysis.diagnostics import (  # noqa: F401
    CODES, RUNTIME_ONLY_CODES, Diagnostic, DiagnosticError,
    DiagnosticReport, LintError, Span)
from dryad_tpu_torch.analysis.plan_rules import (  # noqa: F401
    RULES, STATIC_RULE_CODES, PlanCheck, check_plan)
from dryad_tpu_torch.analysis.subsume import (  # noqa: F401
    Verdict, compare, dataset_share_verdict, implies)
from dryad_tpu_torch.analysis.udf_lint import (  # noqa: F401
    fn_def_site, lint_udf, shippability_of)

__all__ = [
    "CODES", "RUNTIME_ONLY_CODES", "Diagnostic", "DiagnosticError",
    "DiagnosticReport", "LintError", "Span",
    "RULES", "STATIC_RULE_CODES", "PlanCheck", "check_plan",
    "fn_def_site", "lint_udf", "shippability_of", "check_plan_json",
    "canon_prog", "canonical_form_json", "canonical_select",
    "conjuncts_of", "dag_fingerprints", "node_fingerprint",
    "scan_prefix", "semantic_fingerprint",
    "Verdict", "compare", "dataset_share_verdict", "implies",
]


def check_plan_json(plan_json: str, stream: bool = False
                    ) -> DiagnosticReport:
    """Lint a SERIALIZED plan (``plan/serialize.graph_to_json`` output)
    offline — no callables, no sources, no device.  Covers the
    structural subset: placeholder legs in a streamed cluster plan (with
    ``stream=True``), and callable refs a worker could never resolve
    (anonymous ``fn_...`` names: DTA905; opaque params: DTA016).  Op
    spans recorded by the planner make findings point at the query line
    that created the op."""
    import json
    import re

    report = DiagnosticReport()
    d = json.loads(plan_json)

    def walk_params(v, found):
        if isinstance(v, dict):
            if "__fn__" in v:
                found.append(("fn", v["__fn__"]))
            if "__opaque__" in v:
                found.append(("opaque", v["__opaque__"]))
            for x in v.values():
                walk_params(x, found)
        elif isinstance(v, list):
            for x in v:
                walk_params(x, found)

    for st in d.get("stages", []):
        legs = st.get("legs", [])
        for leg in legs:
            if "placeholder" in leg.get("src", {}) and stream:
                report.add("DTA002", "error",
                           f"stage {st['id']}: placeholder leg in a "
                           f"streamed cluster plan", node="placeholder")
        ops = [(o, "leg") for leg in legs for o in leg.get("ops", [])] \
            + [(o, "body") for o in st.get("body", [])]
        for op, where in ops:
            span = op.get("span")
            found = []
            walk_params(op.get("params", {}), found)
            for kind, name in found:
                if kind == "fn" and ":" not in name:
                    # an anonymous fn_<id> ref (graph_to_json's fallback
                    # for unregistered callables) can NEVER resolve on a
                    # worker; a registered name resolves where a module
                    # exports it — a deploy requirement, not an error
                    anonymous = bool(re.fullmatch(r"fn_[0-9a-f]+", name))
                    report.add(
                        "DTA905", "error" if anonymous else "warn",
                        f"stage {st['id']} {where} op {op['kind']!r} "
                        f"references callable {name!r} with no "
                        f"importable module:qualname — "
                        + ("it was never registered for shipping and no "
                           "worker can resolve it" if anonymous else
                           "workers need a module exporting that name"),
                        span=span, node=op["kind"])
                elif kind == "opaque":
                    report.add(
                        "DTA016", "error",
                        f"stage {st['id']} {where} op {op['kind']!r} "
                        f"carries opaque param {name!r} — not "
                        f"serializable for cluster execution", span=span,
                        node=op["kind"])
    return report
