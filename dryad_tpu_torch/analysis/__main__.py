"""CLI: lint serialized plans offline + the analyzer's own selfcheck —
the port of ``python -m dryad_tpu.analysis``.

``python -m dryad_tpu_torch.analysis plan.json [--stream] [--cost]``
runs the structural subset of the plan verifier over a plan JSON
artifact (``plan/serialize.graph_to_json`` output, of either package:
the wire format is one).  Exit code 1 when error-severity findings
exist, so CI can gate committed plan artifacts.  ``--cost`` appends the
offline capacity / row table (``analysis/cost.estimate_plan_json``:
callables and sources are gone from a serialized plan, so bytes are
unknown, but every capacity is structural; size it with ``--nparts``).
No device is touched.

``python -m dryad_tpu_torch.analysis --selfcheck`` is one fast gate
over the analyzer itself: ruff (where installed) and the unused-import
scan of ``dryad_tpu_torch/`` (``analysis/selflint.py``); the code table
against ``docs/diagnostics.md``; the SQL golden plans and the canonical
forms against ``docs/plans/*.json`` / ``*.canon.json``; the obs CLI's
subcommands against ``docs/observability.md``; and an analyzer smoke
over ``docs/plans/*.json``.  It reads those files and never writes
them: they are the JAX package's goldens, which only that package
regenerates.  The golden plans name the JAX package's classes
(``dryad_tpu.sql.rowexpr:Projector``), so the check compares them with
that package prefix rewritten to the port's.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys

from dryad_tpu_torch.analysis import check_plan_json

_REPO = pathlib.Path(__file__).resolve().parent.parent.parent
_PLANS = _REPO / "docs" / "plans"


def _port_prefix(text: str) -> str:
    """A golden plan with the JAX package's class refs named in the
    port's package."""
    return text.replace('"dryad_tpu.', '"dryad_tpu_torch.')


def _selfcheck() -> int:
    from dryad_tpu_torch.analysis.cost import estimate_plan_json
    from dryad_tpu_torch.analysis.diagnostics import (_CODE_FAMILIES,
                                                      CODES,
                                                      render_code_table)
    from dryad_tpu_torch.analysis.selflint import scan_package
    failures = []

    ruff = shutil.which("ruff")
    if ruff is not None:
        proc = subprocess.run(
            [ruff, "check", "--no-cache", "dryad_tpu_torch"],
            cwd=str(_REPO), capture_output=True, text=True)
        if proc.returncode != 0:
            failures.append(f"ruff:\n{proc.stdout}{proc.stderr}")
        else:
            print("ruff: clean")
    else:
        print("ruff: not installed — AST fallback only")
    findings = scan_package()
    if findings:
        failures.append("unused imports:\n" + "\n".join(findings))
    else:
        print("selflint (unused imports): clean")

    docs = _REPO / "docs" / "diagnostics.md"
    if not docs.exists():
        failures.append(f"{docs}: missing")
    elif docs.read_text() != render_code_table():
        failures.append(f"{docs}: differs from diagnostics.CODES "
                        f"rendered by render_code_table()")
    else:
        print("docs/diagnostics.md: in sync with diagnostics.CODES")

    # every code belongs to a documented family, or it would render
    # without a family heading
    orphans = [c for c in CODES
               if not any(c.startswith(p) for p, _ in _CODE_FAMILIES)]
    if orphans:
        failures.append(f"diagnostics codes with no _CODE_FAMILIES "
                        f"entry: {', '.join(sorted(orphans))}")
    else:
        print("diagnostics families: every code covered")

    failures.extend(_sql_golden_check())
    failures.extend(_canon_golden_check())
    failures.extend(_obs_docs_check())

    plans = [p for p in sorted(_PLANS.glob("*.json"))
             if "stages" in json.loads(p.read_text())]
    plan_failures = []
    if not plans:
        plan_failures.append(f"{_PLANS}: no committed example plans to "
                             f"smoke the analyzer over")
    for p in plans:
        js = p.read_text()
        rep = check_plan_json(js)
        if rep.errors:
            plan_failures.append(f"{p.name}: unexpected error "
                                 f"findings:\n" + rep.render())
        cost = estimate_plan_json(js, nparts=8)
        if not cost.stages or not any(s.capacity for s in cost.stages):
            plan_failures.append(f"{p.name}: offline cost pass produced "
                                 f"no capacity table")
    if plans and not plan_failures:
        print(f"analyzer smoke: {len(plans)} committed plan(s) ok")
    failures.extend(plan_failures)

    for f in failures:
        print(f"SELFCHECK FAILURE: {f}", file=sys.stderr)
    return 1 if failures else 0


def _obs_docs_check() -> list:
    """``docs/observability.md`` covers every subcommand of ``python -m
    dryad_tpu_torch.obs`` (``obs/__main__.OBS_COMMANDS``) and the
    surfaces the port has: EXPLAIN ANALYZE, the history's regression
    finding, the latency waterfall and the logging level."""
    doc = _REPO / "docs" / "observability.md"
    if not doc.exists():
        return [f"{doc}: missing"]
    text = doc.read_text()
    from dryad_tpu_torch.obs.__main__ import OBS_COMMANDS
    missing = [f"obs subcommand {c!r}" for c in OBS_COMMANDS
               if c not in text]
    missing += [f"surface {s!r}" for s in
                ("EXPLAIN ANALYZE", "regression_suspect",
                 "latency_waterfall", "DRYAD_LOGGING_LEVEL")
                if s not in text]
    if missing:
        return [f"{doc}: stale — not mentioned: {', '.join(missing)}"]
    print("docs/observability.md: covers every obs subcommand")
    return []


def _sql_golden_check() -> list:
    """Every committed ``docs/plans/*.sql`` lowers (offline, the
    schema-only catalog, nparts=8) to its committed ``<name>.json``
    with the package prefix rewritten, and that JSON round-trips through
    graph_from_json -> graph_to_json byte for byte."""
    from dryad_tpu_torch.plan.serialize import (graph_from_json,
                                                graph_to_json)
    from dryad_tpu_torch.sql import Catalog, offline_plan_json
    failures = []
    sqls = sorted(_PLANS.glob("*.sql"))
    cat_path = _PLANS / "sql_catalog.json"
    if not sqls:
        return [f"{_PLANS}: no committed .sql golden queries"]
    if not cat_path.exists():
        return [f"{cat_path}: missing (the catalog the committed .sql "
                f"goldens compile against)"]
    catalog = Catalog.load(str(cat_path))
    for sp in sqls:
        golden = sp.with_suffix(".json")
        if not golden.exists():
            failures.append(f"{sp.name}: no committed golden "
                            f"{golden.name}")
            continue
        js = offline_plan_json(catalog, sp.read_text(), nparts=8,
                               origin=sp.name)
        if js != _port_prefix(golden.read_text()):
            failures.append(f"{golden.name}: differs from the port's "
                            f"lowering of {sp.name}")
            continue
        d = json.loads(js)
        slots = {f"{st['id']}:{li}": None for st in d["stages"]
                 for li, leg in enumerate(st["legs"])
                 if "source" in leg["src"]}
        try:
            js2 = graph_to_json(graph_from_json(js, fn_table={},
                                                sources=slots))
        except (TypeError, ValueError, KeyError) as e:
            failures.append(f"{golden.name}: does not round-trip "
                            f"through graph_from_json: {e!r}")
            continue
        if js2 != js:
            failures.append(f"{golden.name}: graph_from_json -> "
                            f"graph_to_json is not byte-identical")
    if not failures:
        print(f"sql goldens: {len(sqls)} committed .sql quer"
              f"{'ies' if len(sqls) != 1 else 'y'} lower to their "
              f"committed plans and round-trip")
    return failures


def _canon_golden_check() -> list:
    """Every committed ``docs/plans/*.sql`` canonicalizes
    (``analysis/canon.canonical_form_json``, the schema-only catalog) to
    its committed ``<name>.canon.json`` byte for byte: a change to the
    pass moves every semantic fingerprint at once."""
    from dryad_tpu_torch.analysis.canon import canonical_form_json
    from dryad_tpu_torch.sql import Catalog, compile_query
    failures = []
    sqls = sorted(_PLANS.glob("*.sql"))
    cat_path = _PLANS / "sql_catalog.json"
    if not sqls or not cat_path.exists():
        return []     # _sql_golden_check already reports the gap
    catalog = Catalog.load(str(cat_path))
    for sp in sqls:
        golden = sp.with_suffix(".canon.json")
        if not golden.exists():
            failures.append(f"{sp.name}: no committed canonical form "
                            f"{golden.name}")
            continue
        _mode, bound = compile_query(catalog, sp.read_text(),
                                     origin=sp.name)
        if canonical_form_json(catalog, bound) != golden.read_text():
            failures.append(f"{golden.name}: differs from the "
                            f"canonicalization of {sp.name}")
    if not failures:
        print(f"canon goldens: {len(sqls)} committed .sql quer"
              f"{'ies' if len(sqls) != 1 else 'y'} canonicalize to "
              f"their committed forms")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dryad_tpu_torch.analysis",
        description="statically lint a serialized plan "
                    "(graph_to_json output), or the analyzer itself")
    ap.add_argument("plan", nargs="?",
                    help="plan JSON path ('-' for stdin)")
    ap.add_argument("--stream", action="store_true",
                    help="the plan will execute over cluster streams: "
                         "apply the streamed-mode op rules")
    ap.add_argument("--cost", action="store_true",
                    help="append the offline per-stage capacity/row "
                         "cost table (analysis/cost.py)")
    ap.add_argument("--nparts", type=int, default=1,
                    help="partition count for --cost row bounds "
                         "(default 1)")
    ap.add_argument("--selfcheck", action="store_true",
                    help="lint the analyzer itself: ruff/selflint, the "
                         "committed docs and goldens, an analyzer smoke")
    args = ap.parse_args(argv)
    if args.selfcheck:
        return _selfcheck()
    if args.plan is None:
        ap.error("a plan path is required (or --selfcheck)")
    if args.plan == "-":
        plan_json = sys.stdin.read()
    else:
        with open(args.plan) as f:
            plan_json = f.read()
    report = check_plan_json(plan_json, stream=args.stream)
    print(report.render())
    if args.cost:
        from dryad_tpu_torch.analysis.cost import estimate_plan_json
        print()
        print(estimate_plan_json(plan_json, nparts=args.nparts).render())
    return 1 if report.errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
