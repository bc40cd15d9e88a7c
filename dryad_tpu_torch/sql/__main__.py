"""SQL CLI — ``python -m dryad_tpu_torch.sql --catalog cat.json [...]``
(the port of ``python -m dryad_tpu.sql``).

* one-shot: ``-e "EXPLAIN [COST | ANALYZE] SELECT ..."`` or ``-f
  query.sql`` prints the plan (EXPLAIN; ANALYZE runs the query once and
  appends measured per-stage actuals against the cost model) or
  executes and prints rows (plain SELECT, when the catalog's tables are
  loadable);
* REPL (default): reads ``;``-terminated statements; ``\\d`` lists
  catalog tables, ``\\q`` quits.

``--device`` (default ``cuda``) is the device a SELECT, an EXPLAIN
COST or an EXPLAIN ANALYZE runs on; ``--nparts`` the partition count.
Plain ``EXPLAIN`` works against SCHEMA-ONLY serialized catalogs with no
data and no device at all.  DTA3xx compile errors print with their
line:column spans and exit 2 (one-shot mode); malformed invocations,
statements the port refuses (EMIT EVERY) and execution over a
schema-only table exit 3.
"""

from __future__ import annotations

import argparse
import sys

from dryad_tpu_torch.sql import Catalog, SqlError, offline_plan_json

_PROMPT = "dryad-sql> "


def _print_table(table, limit: int = 50) -> None:
    cols = list(table)
    if not cols:
        print("(no columns)")
        return
    n = len(table[cols[0]]) if cols else 0
    print(" | ".join(cols))
    print("-+-".join("-" * len(c) for c in cols))
    for i in range(min(n, limit)):
        row = []
        for c in cols:
            v = table[c][i]
            if isinstance(v, bytes):
                v = v.decode("utf-8", "replace")
            elif hasattr(v, "item"):
                v = v.item()
            row.append(str(v))
        print(" | ".join(row))
    if n > limit:
        print(f"... ({n - limit} more rows)")
    print(f"({n} row{'s' if n != 1 else ''})")


class _Session:
    """Builds the real Context (on ``device``) only when a statement
    executes or needs source statistics; plain EXPLAIN stays offline
    (SchemaContext) so schema-only catalogs work with no device."""

    def __init__(self, catalog: Catalog, nparts: int, device: str):
        self.catalog = catalog
        self.nparts = nparts
        self.device = device
        self._ctx = None

    def ctx(self):
        if self._ctx is None:
            from dryad_tpu_torch.api.dataset import Context
            self._ctx = Context(device=self.device, nparts=self.nparts)
        return self._ctx

    def run(self, text: str) -> int:
        from dryad_tpu_torch.plan.planner import plan_query
        from dryad_tpu_torch.sql import SchemaContext, compile_query, lower
        mode, bound = compile_query(self.catalog, text)  # compile ONCE
        if mode == "explain":
            # plain EXPLAIN stays fully offline (schema-only catalogs,
            # no device)
            sctx = SchemaContext(nparts=self.nparts)
            ds, _ = lower(sctx, self.catalog, bound)
            print(plan_query(ds.node, self.nparts, hosts=1,
                             config=sctx.config).explain())
            return 0
        # cost needs real source statistics -> a real Context; ANALYZE
        # also runs the query once (obs/analyze.py)
        ds, _ = lower(self.ctx(), self.catalog, bound)
        if mode == "explain_cost":
            print(ds.explain(verify=True, cost=True))
            return 0
        if mode == "explain_analyze":
            print(ds.explain(analyze=True))
            return 0
        _print_table(ds.collect())
        return 0


def _repl(sess: _Session) -> int:
    print(f"dryad_tpu_torch sql — tables: "
          f"{', '.join(sess.catalog.names()) or '(empty catalog)'}; "
          f"\\d describes, \\q quits; terminate statements with ';'")
    buf = []
    while True:
        try:
            line = input(_PROMPT if not buf else "      ... ")
        except EOFError:
            print()
            return 0
        except KeyboardInterrupt:
            buf = []
            print()
            continue
        s = line.strip()
        if not buf and s in ("\\q", "exit", "quit"):
            return 0
        if not buf and s == "\\d":
            for name in sess.catalog.names():
                t = sess.catalog.get(name)
                cols = ", ".join(f"{c} {spec['kind']}"
                                 + (f"({spec['max_len']})"
                                    if spec["kind"] == "str" else
                                    f":{spec['dtype']}")
                                 for c, spec in t.schema.items())
                print(f"  {name} [{t.kind}, ~{t.rows} rows]: {cols}")
            continue
        buf.append(line)
        if not s.endswith(";"):
            continue
        text = "\n".join(buf)
        buf = []
        try:
            sess.run(text)
        except SqlError as e:
            print(e.report.render(), file=sys.stderr)
        except Exception as e:                     # keep the REPL alive
            print(f"error: {e}", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dryad_tpu_torch.sql",
        description="SQL front end: REPL / one-shot EXPLAIN+execute "
                    "over a registered catalog")
    ap.add_argument("--catalog", required=True,
                    help="serialized catalog JSON (sql.Catalog.save)")
    ap.add_argument("-e", "--execute", default=None, metavar="QUERY",
                    help="one-shot statement (EXPLAIN [COST | ANALYZE]"
                         " ... or SELECT ...)")
    ap.add_argument("-f", "--file", default=None,
                    help="read the one-shot statement from a .sql file")
    ap.add_argument("--nparts", type=int, default=8,
                    help="partition count of plans and runs (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="device a SELECT, EXPLAIN COST or EXPLAIN "
                         "ANALYZE runs on (default cuda; plain EXPLAIN "
                         "needs none)")
    ap.add_argument("--plan-json", action="store_true",
                    help="with -e/-f EXPLAIN: print the lowered plan "
                         "JSON instead of the textual plan")
    args = ap.parse_args(argv)
    try:
        catalog = Catalog.load(args.catalog)
    except (OSError, ValueError, KeyError) as e:
        print(f"dryad_tpu_torch.sql: cannot load catalog "
              f"{args.catalog!r}: {e}", file=sys.stderr)
        return 3
    text = args.execute
    if args.file:
        try:
            with open(args.file) as f:
                text = f.read()
        except OSError as e:
            print(f"dryad_tpu_torch.sql: {e}", file=sys.stderr)
            return 3
    sess = _Session(catalog, args.nparts, args.device)
    if text is None:
        return _repl(sess)
    try:
        if args.plan_json:
            print(offline_plan_json(catalog, text, nparts=args.nparts))
            return 0
        return sess.run(text)
    except SqlError as e:
        print(e.report.render(), file=sys.stderr)
        return 2
    except (ValueError, NotImplementedError) as e:
        print(f"dryad_tpu_torch.sql: {e}", file=sys.stderr)
        return 3


if __name__ == "__main__":
    sys.exit(main())
