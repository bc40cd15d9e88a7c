"""AST-based determinism + shippability lint for user UDFs — the port
of ``dryad_tpu/analysis/udf_lint.py``.

Replay-based fault tolerance is sound only when UDFs are deterministic: a
replayed stage must recompute byte-identical output.  This module walks
the UDF's AST and flags the constructs that break replay:

* wall-clock / RNG / uuid / os.urandom calls without a fixed seed, and
  torch's global-generator calls (``torch.rand*``, ``torch.randperm``,
  ``torch.normal``) without ``generator=`` (DTA101) — import aliases
  resolve before matching, so ``import time as t; t.time()`` is caught
  under its real dotted name
* ``id()`` and builtin ``hash()`` — interpreter/object-identity dependent
  (``hash`` of str/bytes is salted per process) (DTA102)
* iteration over sets — order varies across processes (DTA103)
* mutation of captured (closure/global) state — replays observe
  different values (DTA104)
* capture of a tensor on the card (any size) or of a large CPU tensor or
  ndarray constant — the bytes ship with every task that references the
  UDF, and a captured device buffer pins one process's device memory
  (DTA105)

``shippability_of`` is the importability check a cluster shipper applies
at submit, surfaced pre-submit with the UDF's definition site.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Callable, List, Optional, Tuple

from dryad_tpu_torch.analysis.diagnostics import Diagnostic, Span

__all__ = ["lint_udf", "fn_def_site", "shippability_of"]

# dotted-call prefixes that are nondeterministic across replays
_NONDET_PREFIXES = ("time.", "random.", "np.random.", "numpy.random.",
                    "secrets.", "uuid.")
# exact dotted calls that are nondeterministic
_NONDET_CALLS = {"os.urandom", "os.getpid", "datetime.datetime.now",
                 "datetime.datetime.utcnow", "datetime.date.today"}
# torch's calls on its GLOBAL generator (the torch counterpart of
# numpy's module-level RNG): nondeterministic unless ``generator=`` names
# an explicitly seeded one
_TORCH_RNG_PREFIX = "torch.rand"        # rand, randn, randint, randperm, *_like
_TORCH_RNG_CALLS = {"torch.normal"}
# seeded-constructor suffixes: a constant argument fixes the stream, so
# the call IS deterministic (np.random.RandomState(0), random.Random(7),
# np.random.default_rng(3))
_SEEDED_CTORS = (".RandomState", ".default_rng", ".Random", ".PRNGKey",
                 ".key", ".seed")
# methods that mutate their receiver in place
_MUTATORS = {"append", "extend", "insert", "add", "update", "setdefault",
             "pop", "popitem", "remove", "discard", "clear", "sort",
             "reverse"}
# a captured CPU tensor / ndarray at or above this many bytes is "large"
# for DTA105 (it re-serializes into every task envelope); a tensor on the
# card is flagged at ANY size — a captured device buffer additionally
# pins the submitting process's device memory into the program
DTA105_NDARRAY_BYTES = 64 << 10


def _captured_payload(v) -> Optional[str]:
    """Why a captured value is heavyweight for shipping, or None.
    Duck-typed: a torch tensor exposes ``.is_cuda``, a numpy ndarray
    ``.nbytes`` without it."""
    if v is None or isinstance(v, (int, float, str, bytes, bool)):
        return None
    nbytes = getattr(v, "nbytes", None)
    if nbytes is None:
        return None
    if getattr(v, "is_cuda", False) is True:
        return (f"a device array ({int(nbytes)} bytes) on the card — the "
                f"buffer transfers to host and re-ships with every task "
                f"envelope; pass it through the query as a dataset "
                f"(broadcast()/cross_apply) instead")
    if int(nbytes) >= DTA105_NDARRAY_BYTES:
        return (f"a {int(nbytes)}-byte ndarray constant — it "
                f"re-serializes into every task envelope; load it "
                f"worker-side or pass it as a broadcast dataset")
    return None


def fn_def_site(fn: Callable) -> Optional[Span]:
    """Definition site (file:line) of a Python callable, if knowable."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return None
    return Span(code.co_filename, code.co_firstlineno,
                getattr(fn, "__qualname__", ""))


def shippability_of(fn: Callable) -> Optional[str]:
    """None if ``fn`` ships to a cluster (importable as module:qualname,
    or a shippable VALUE serializing as data — plan/serialize.ship_ref_of,
    e.g. SQL row-expression programs), else a human explanation."""
    from dryad_tpu_torch.plan.serialize import import_ref, ship_ref_of
    if import_ref(fn) is not None or ship_ref_of(fn) is not None:
        return None
    qual = getattr(fn, "__qualname__", repr(fn))
    kind = "lambda" if "<lambda>" in str(qual) else \
        "closure/non-importable callable"
    return (f"{kind} {qual!r} cannot ship to workers — move it to module "
            f"level, or register it by name via Context(fn_table=...)")


def _alias_ref(v) -> Optional[str]:
    """Real dotted name behind a bound value: module objects resolve to
    ``module.__name__`` (``import time as t`` -> ``time``),
    from-imported classes/functions to ``module.qualname``
    (``from datetime import datetime`` -> ``datetime.datetime``)."""
    import types
    if isinstance(v, types.ModuleType):
        return v.__name__
    mod = getattr(v, "__module__", None)
    qual = getattr(v, "__qualname__", None)
    if isinstance(mod, str) and isinstance(qual, str) \
            and "." not in qual:
        return f"{mod}.{qual}"
    return None


def _dotted(node: ast.AST) -> Optional[str]:
    """a.b.c attribute chain as a dotted string (None for anything else)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _fn_source(fn: Callable) -> Optional[Tuple[ast.AST, str, int]]:
    """(parsed AST, filename, first source line) or None when the source
    is unavailable (builtins, C extensions, exec'd code)."""
    try:
        lines, start = inspect.getsourcelines(fn)
    except (OSError, TypeError):
        return None
    src = textwrap.dedent("".join(lines))
    try:
        tree = ast.parse(src)
    except SyntaxError:
        # inline lambdas may yield an unparsable statement fragment; the
        # shippability check still covers them via the code object
        return None
    fname = getattr(fn, "__code__", None)
    return tree, (fname.co_filename if fname else "<unknown>"), start


class _UdfVisitor(ast.NodeVisitor):
    def __init__(self, fn: Callable):
        self.findings: List[Tuple[str, str, int]] = []  # (code, msg, line)
        code = getattr(fn, "__code__", None)
        self.freevars = set(code.co_freevars) if code else set()
        # params + locally-assigned names compile to LOAD_FAST — a local
        # shadowing a module-level array captures nothing
        self.local_names = set(code.co_varnames) if code else set()
        # captured globals that are MUTABLE containers: mutating them in a
        # UDF leaks state across replays/partitions
        self.mutable_globals = {
            name for name, v in getattr(fn, "__globals__", {}).items()
            if isinstance(v, (list, dict, set, bytearray))}
        # concrete captured VALUES for the payload lint (DTA105): closure
        # cells by freevar name; referenced globals resolve lazily
        self._globals = getattr(fn, "__globals__", {})
        self.captured_values = {}
        clo = getattr(fn, "__closure__", None) or ()
        if code is not None:
            for name, cell in zip(code.co_freevars, clo):
                try:
                    self.captured_values[name] = cell.cell_contents
                except ValueError:   # not yet filled (recursive def)
                    pass
        self._payload_flagged: set = set()
        # import-alias resolution: real dotted name behind each bound
        # name, so `import time as t; t.time()` matches "time." and
        # `from datetime import datetime; datetime.now()` matches
        # "datetime.datetime.now".  Seeded from captured values +
        # globals; inline import statements add entries during the walk.
        self.alias_map: dict = {}
        for name, v in list(self._globals.items()) \
                + list(self.captured_values.items()):
            ref = _alias_ref(v)
            if ref is not None:
                self.alias_map[name] = ref
        # names bound by import statements INSIDE the function body —
        # they are locals too, but the import tells us exactly what
        # they are, so they resolve despite the local-shadow rule
        self._inline_imports: set = set()

    # -- heavyweight captures (DTA105) ------------------------------------

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load) \
                and node.id not in self._payload_flagged \
                and node.id not in self.local_names:
            if node.id in self.captured_values:
                v = self.captured_values[node.id]
            elif node.id in self.freevars:
                v = None
            else:
                v = self._globals.get(node.id)
            why = _captured_payload(v)
            if why is not None:
                self._payload_flagged.add(node.id)
                self._flag("DTA105",
                           f"closes over {node.id!r}: {why}", node)
        self.generic_visit(node)

    def _flag(self, code: str, msg: str, node: ast.AST) -> None:
        self.findings.append((code, msg, getattr(node, "lineno", 1)))

    # -- import-alias resolution ------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.asname:
                self.alias_map[a.asname] = a.name
                self._inline_imports.add(a.asname)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module and not node.level:
            for a in node.names:
                self.alias_map[a.asname or a.name] = \
                    f"{node.module}.{a.name}"
                self._inline_imports.add(a.asname or a.name)
        self.generic_visit(node)

    def _canon_dotted(self, dotted: str) -> str:
        """Resolve the head of a dotted call through import aliases.
        Plain locals shadow the surrounding module's aliases, but a
        name bound by an import statement in the function body (also
        a local) resolves — the import says exactly what it is."""
        head, dot, rest = dotted.partition(".")
        if head in self.local_names \
                and head not in self._inline_imports:
            return dotted
        ref = self.alias_map.get(head)
        if ref is None:
            return dotted
        return f"{ref}{dot}{rest}" if rest else ref

    # -- nondeterministic calls -------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        if dotted is not None:
            dotted = self._canon_dotted(dotted)
            if dotted == "id":
                self._flag("DTA102",
                           "id() depends on interpreter object placement "
                           "— never stable across replays", node)
            elif dotted == "hash":
                self._flag("DTA102",
                           "builtin hash() is salted per process for "
                           "str/bytes — use ops.hashing for stable keys",
                           node)
            elif dotted in ("set", "frozenset"):
                pass  # construction is fine; iteration is flagged below
            elif self._is_nondet(dotted, node):
                self._flag("DTA101",
                           f"call to {dotted}() is nondeterministic "
                           f"across replays — seed it explicitly or hoist "
                           f"it out of the query", node)
        # mutating a captured container: captured.append(...), including
        # subscripted receivers like state["k"].append(...) (whose dotted
        # form is None) — outside the dotted guard on purpose
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            root = node.func.value
            while isinstance(root, (ast.Attribute, ast.Subscript)):
                root = root.value
            if isinstance(root, ast.Name) and (
                    root.id in self.freevars
                    or root.id in self.mutable_globals):
                self._flag("DTA104",
                           f"mutates captured state "
                           f"{root.id!r}.{node.func.attr}() — UDFs "
                           f"must be pure for replay soundness", node)
        self.generic_visit(node)

    def _is_nondet(self, dotted: str, node: ast.Call) -> bool:
        if dotted in _NONDET_CALLS:
            return True
        if dotted.startswith(_TORCH_RNG_PREFIX) \
                or dotted in _TORCH_RNG_CALLS:
            return not any(kw.arg == "generator" for kw in node.keywords)
        if not (dotted + ".").startswith(_NONDET_PREFIXES):
            return False
        # seeded constructors with a literal argument (positional or
        # keyword: default_rng(seed=42)) are deterministic
        if dotted.endswith(_SEEDED_CTORS) and any(
                isinstance(a, ast.Constant)
                for a in list(node.args)
                + [kw.value for kw in node.keywords]):
            return False
        return True

    # -- set iteration order ----------------------------------------------

    def _iter_is_set(self, it: ast.AST) -> bool:
        if isinstance(it, ast.Set):
            return True
        if isinstance(it, ast.Call):
            d = _dotted(it.func)
            return d in ("set", "frozenset")
        return False

    def visit_For(self, node: ast.For) -> None:
        if self._iter_is_set(node.iter):
            self._flag("DTA103",
                       "iteration over a set — element order varies by "
                       "process (hash salting); sort first", node)
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension) -> None:
        if self._iter_is_set(node.iter):
            self._flag("DTA103",
                       "comprehension over a set — element order varies "
                       "by process; sort first", node.iter)
        self.generic_visit(node)

    # -- captured-state mutation ------------------------------------------

    def visit_Global(self, node: ast.Global) -> None:
        self._flag("DTA104",
                   f"rebinds global(s) {', '.join(node.names)} — UDFs "
                   f"must be pure for replay soundness", node)

    def visit_Nonlocal(self, node: ast.Nonlocal) -> None:
        self._flag("DTA104",
                   f"rebinds closure variable(s) {', '.join(node.names)} "
                   f"— UDFs must be pure for replay soundness", node)

    def _check_store_target(self, tgt: ast.AST, node: ast.AST) -> None:
        if isinstance(tgt, ast.Subscript):
            root = tgt.value
            while isinstance(root, (ast.Attribute, ast.Subscript)):
                root = root.value
            if isinstance(root, ast.Name) and (
                    root.id in self.freevars
                    or root.id in self.mutable_globals):
                self._flag("DTA104",
                           f"assigns into captured state {root.id!r}[...] "
                           f"— UDFs must be pure for replay soundness",
                           node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_store_target(t, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_store_target(node.target, node)
        self.generic_visit(node)


def lint_udf(fn: Callable, role: str = "udf") -> List[Diagnostic]:
    """Determinism findings for one callable (empty when the source is
    unavailable — builtins / C extensions are framework-owned)."""
    mod = getattr(fn, "__module__", "") or ""
    if mod.split(".")[0] in ("torch", "numpy", "builtins"):
        return []
    parsed = _fn_source(fn)
    if parsed is None:
        return []
    tree, fname, first_line = parsed
    v = _UdfVisitor(fn)
    v.visit(tree)
    qual = getattr(fn, "__qualname__", role)
    out = []
    for code, msg, lineno in v.findings:
        out.append(Diagnostic(
            code, "warn", f"{role} {qual!r}: {msg}",
            Span(fname, first_line + lineno - 1, str(qual)), node=role))
    return out
