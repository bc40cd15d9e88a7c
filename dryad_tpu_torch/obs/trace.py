"""Span-level tracing — the port of ``dryad_tpu/obs/trace.py``.

Every timed operation is a span (trace_id / span_id / parent_id, a
monotonic duration, attributes).  Spans are ordinary EventLog events
(kind ``"span"``), so ONE JSONL stream carries the stage lifecycle, the
metrics snapshot and the trace; the exporters live next door
(``obs/chrome.py`` -> Perfetto-loadable Chrome trace JSON,
``obs/critical_path.py`` -> "where did the wall time go").  The port's
Run emits a ``run`` job span and one ``stage`` span per stage it
computes, each parented to the job span; a Run with no event log of its
own (the executor's no-op sink) emits them to the installed process
sink.  Below them the program opens spans where the work happens
(``scope``): a terminal's ``query`` root with its ``plan`` and
``collect`` / ``cache``, each fused op (``op.<kind>``), each exchange
(``exchange.<kind>``) with its ``pack`` and ``unpack``, the key ``hash``,
the ``sort`` lanes and the ``settle``; an in-memory ``do_while`` opens
a ``loop`` (``iters``, ``stages``, ``planned``, and ``iters_run`` on
close) with one ``loop.iter`` (``i``) around each iteration's run.
Their attributes come from shapes and capacities, never from a device
read.

Clock: a span stamps its start and end as integer nanoseconds of ONE
clock, ``time.time_ns()`` (``start_ns`` / ``end_ns`` on the event), the
clock torch.profiler stamps its host-side runtime events in, so a kernel
launch falls inside the span that issued it.  ``t0`` (seconds) and
``dur_s`` are derived from the same pair.  A stage on the deferred path
still spans its enqueue only; its device time is found through the
launches made inside its spans.

The wire context (``ctx()``, ``current_ctx``, ``tracing(sink, ctx)``)
is the JAX package's, so spans adopted from another process link into
the submitting trace; the port has no worker processes yet, so only the
driver uses it.

Overhead contract: with no sink installed, or a sink's level <= 1,
``span()`` / ``start()`` return a shared null object — one env read and
one comparison on the hot path, no event built.  A site inside the
program guards its ``scope`` with ``if trace.ACTIVE:`` (true while a
process sink is installed): with tracing off it costs that one
module-global read and test, and builds no object and no attribute.
The process-sink fallback of a Run with no event log goes through the
same sink, so an installed sink records a whole job.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, Optional

__all__ = ["Span", "NULL", "span", "scope", "tally", "start", "finish",
           "tracing", "install", "uninstall", "leveled", "current_ctx",
           "ctx_of", "tracing_enabled"]

_lock = threading.Lock()
_seq = 0
_sink = None                       # process-global installed event sink
# whether a process sink is installed: the one read a program site makes
# before it opens a ``scope`` (read it as ``trace.ACTIVE``: it is rebound)
ACTIVE = False
_root: Optional[Dict[str, Any]] = None   # adopted wire context
_tls = threading.local()


def _level() -> int:
    try:
        return int(os.environ.get("DRYAD_LOGGING_LEVEL", "2"))
    except ValueError:
        return 2


def _sink_level(sink) -> int:
    """Effective verbosity for a sink: an EventLog carries its own
    explicit ``level`` (which would filter span events anyway — honor it
    and skip the work); bare callables fall back to the env level."""
    lvl = getattr(sink, "level", None)
    return lvl if isinstance(lvl, int) else _level()


class _LeveledSink:
    """A bare callable sink tagged with an explicit verbosity level, so
    the span gate treats it exactly like an EventLog.  Used by wrapper
    sinks (the Run's job-tagging sink, ``exec/recovery.py``) to inherit
    the wrapped EventLog's decision."""

    __slots__ = ("_fn", "level")

    def __init__(self, fn, level: int):
        self._fn, self.level = fn, level

    def __call__(self, e) -> None:
        self._fn(e)


def leveled(fn, level):
    """Tag ``fn`` with an explicit span-gating level; a non-int level
    leaves the env-var fallback in place."""
    return _LeveledSink(fn, level) if isinstance(level, int) else fn


def tracing_enabled() -> bool:
    """True when spans would actually be recorded (sink + level >= 2)."""
    return _sink is not None and _sink_level(_sink) >= 2


def _new_id() -> str:
    """Process-unique span/trace id (pid-prefixed so ids from driver and
    worker processes can never collide in one stream)."""
    global _seq
    with _lock:
        _seq += 1
        n = _seq
    return f"{os.getpid():x}-{n:x}"


class Span:
    """One timed operation.  Created via ``span()``/``start()``; emits
    itself as a ``{"event": "span", ...}`` record on finish."""

    __slots__ = ("name", "kind", "trace_id", "span_id", "parent_id",
                 "attrs", "start_ns", "_sink", "_done")

    def __init__(self, name: str, kind: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], attrs: Dict[str, Any], sink):
        self.name, self.kind = name, kind
        self.trace_id, self.span_id, self.parent_id = (trace_id, span_id,
                                                       parent_id)
        self.attrs = dict(attrs)
        self.start_ns = time.time_ns()
        self._sink = sink
        self._done = False

    def set(self, **attrs) -> "Span":
        """Attach attributes (bytes read, rows, retries, ...)."""
        self.attrs.update(attrs)
        return self

    def ctx(self) -> Dict[str, str]:
        """Wire context for cross-process propagation: children created
        under this context get parent_id = this span."""
        return {"trace": self.trace_id, "parent": self.span_id}

    def finish(self, **attrs) -> None:
        if self._done:          # idempotent: losing duplicates may race
            return
        self._done = True
        end_ns = time.time_ns()
        if attrs:
            self.attrs.update(attrs)
        e = {"event": "span", "name": self.name, "kind": self.kind,
             "trace": self.trace_id, "span": self.span_id,
             "t0": round(self.start_ns / 1e9, 6),
             "dur_s": round((end_ns - self.start_ns) / 1e9, 6),
             "start_ns": self.start_ns, "end_ns": end_ns}
        if self.parent_id:
            e["parent"] = self.parent_id
        if self.attrs:
            e["attrs"] = dict(self.attrs)
        try:
            self._sink(e)
        except Exception:
            pass                # telemetry must never fail the job


class _NullSpan:
    """Shared no-op span when tracing is off — same surface as Span."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def ctx(self) -> None:
        return None

    def finish(self, **attrs) -> None:
        pass


NULL = _NullSpan()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _lineage(parent) -> tuple:
    """(trace_id, parent_span_id) from an explicit parent Span, the
    thread-current span, or the adopted (wire) root context."""
    if isinstance(parent, Span):
        return parent.trace_id, parent.span_id
    st = _stack()
    if st:
        top = st[-1]
        return top.trace_id, top.span_id
    if _root is not None:
        return _root.get("trace"), _root.get("parent")
    return None, None


def start(name: str, kind: str = "internal", parent: Optional[Span] = None,
          sink=None, **attrs) -> Optional[Span]:
    """Begin a span WITHOUT making it thread-current (spans that
    overlap from one thread).  Returns None when tracing is off;
    ``finish(None)`` is a safe no-op.  ``sink`` overrides the installed
    process sink (a Run emits its spans through its own sink, so they
    land in the run's event log)."""
    use = sink if sink is not None else _sink
    if use is None or _sink_level(use) < 2:
        return None
    trace_id, parent_id = _lineage(parent)
    return Span(name, kind, trace_id or _new_id(), _new_id(), parent_id,
                attrs, use)


def finish(sp: Optional[Span], **attrs) -> None:
    if sp is not None:
        sp.finish(**attrs)


class _Scope:
    """A recording ``scope``: pushes its span on the thread's stack on
    entry, pops and finishes it on exit (a class, not a generator: the
    program's inner sites open many)."""

    __slots__ = ("sp",)

    def __init__(self, sp: Span):
        self.sp = sp

    def __enter__(self) -> Span:
        _stack().append(self.sp)
        return self.sp

    def __exit__(self, et, ev, tb) -> bool:
        sp = self.sp
        if et is not None:
            sp.attrs.setdefault("error", et.__name__)
        st = _stack()
        if st and st[-1] is sp:
            st.pop()
        else:
            try:
                st.remove(sp)
            except ValueError:
                pass
        sp.finish()
        return False


class _NullScope:
    """The shared scope that records nothing."""

    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return NULL

    def __exit__(self, et, ev, tb) -> bool:
        return False


_NULL_SCOPE = _NullScope()


def span(name: str, kind: str = "internal",
         parent: Optional[Span] = None, sink=None, **attrs):
    """Scoped span (a context manager), pushed on the thread-local stack
    so nested spans and ``current_ctx()`` parent-link to it.  Enters as
    NULL when tracing is off.  An escaping exception is recorded as an
    ``error`` attr."""
    sp = start(name, kind, parent=parent, sink=sink, **attrs)
    return _NULL_SCOPE if sp is None else _Scope(sp)


def scope(name: str, kind: str = "internal",
          attrs: Optional[Dict[str, Any]] = None, nest: bool = True):
    """A span of the program's own work, as a context manager: the child
    of the thread-current span, emitted to that span's sink (else to the
    process sink), pushed on the thread's stack for its duration.  With
    ``nest=False`` it records nothing inside an open span of the same
    name (a sort that calls sorts is one ``sort``).  Records nothing
    when no sink at level 2 would take it.  Call sites guard it with
    ``if trace.ACTIVE:``."""
    st = _stack()
    if st:
        top = st[-1]
        if not nest and top.name == name:
            return _NULL_SCOPE
        use = top._sink
    else:
        use = _sink
    if use is None or _sink_level(use) < 2:
        return _NULL_SCOPE
    trace_id, parent_id = _lineage(None)
    return _Scope(Span(name, kind, trace_id or _new_id(), _new_id(),
                       parent_id, attrs or {}, use))


def tally(prefix: str, key: str, n: int) -> None:
    """Add ``n`` to attribute ``key`` of this thread's innermost open
    span whose name starts with ``prefix`` (an exchange's bytes, summed
    over the send grids its packs build); nothing when none is open."""
    for sp in reversed(_stack()):
        if sp.name.startswith(prefix):
            sp.attrs[key] = sp.attrs.get(key, 0) + n
            return


def install(sink, ctx: Optional[Dict[str, Any]] = None) -> None:
    """Install the process-global span sink (and optional adopted wire
    context).  ``Context(event_log=...)`` calls this, so spans with no
    sink of their own flow into the job's EventLog."""
    global _sink, _root, ACTIVE
    _sink = sink
    _root = dict(ctx) if isinstance(ctx, dict) else None
    ACTIVE = sink is not None


def uninstall(sink) -> None:
    """Detach ``sink`` if it is the installed one (EventLog.close calls
    this so spans never accumulate in a closed log's memory)."""
    global _sink, _root, ACTIVE
    if _sink is sink:
        _sink = None
        _root = None
        ACTIVE = False


@contextlib.contextmanager
def tracing(sink, ctx: Optional[Dict[str, Any]] = None):
    """Scoped ``install``: adopt a wire context for one scope, restoring
    the previous sink after.  The calling thread's span stack is swapped
    out for the duration: adopting a REMOTE parent means any local open
    span must not shadow it."""
    global _sink, _root, ACTIVE
    prev = (_sink, _root)
    prev_stack = getattr(_tls, "stack", None)
    _tls.stack = []
    _sink = sink
    _root = dict(ctx) if isinstance(ctx, dict) else None
    ACTIVE = sink is not None
    try:
        yield
    finally:
        _sink, _root = prev
        ACTIVE = _sink is not None
        _tls.stack = prev_stack if prev_stack is not None else []


def current_ctx() -> Optional[Dict[str, str]]:
    """Wire context of the thread-current span (or the adopted root)."""
    st = _stack()
    if st:
        return st[-1].ctx()
    if _root is not None:
        return dict(_root)
    return None


def ctx_of(sp) -> Optional[Dict[str, str]]:
    """Wire context of ``sp`` (None-safe: falls back to current_ctx)."""
    if sp is not None and not isinstance(sp, _NullSpan):
        return sp.ctx()
    return current_ctx()
