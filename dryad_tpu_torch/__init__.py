"""dryad_tpu_torch — the PyTorch / CUDA port of dryad_tpu.

A second package beside ``dryad_tpu`` (the JAX reference, which stays as
it is).  Its module layout mirrors ``dryad_tpu`` so each counterpart is
easy to find.  It imports torch and numpy, never jax and nothing of
``dryad_tpu``.  Every TPU (Pallas) kernel on a ported path is a
hand-written CUDA kernel for Hopper under ``ops/csrc/``, built on first
use; each has a plain PyTorch version that runs only for CPU tensors.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  Ported end to end, with P logical partitions on one
device and a hash or range exchange between them: WordCount
(from_columns -> split_words -> group_by count -> collect),
GroupByReduce (group_by with builtin or user-defined ``Decomposable``
aggregates, select, where), TeraSort (order_by: sampled split points,
a range exchange, a local sort), with the rest of the sort family
(range_partition, assume_range_partition / assume_order_by, take,
distinct, group_top_k, group_median), and PageRank (from_columns -> join
-> cache -> do_while -> collect: two-leg join stages, inner and left,
with the lookup-table form; with_capacity; the in-memory cache), and
k-means (cross_apply over a broadcast centroid table -> group_by mean
under do_while), with broadcast joins, the set operators (union,
intersect, except_, concat) and the terminal scalars (count, sum, min,
max, mean, any, all, first, aggregate), and skewed joins (a hot-key
salted join exchange; right and full joins, group_join) with the
positional operators (zip_with, with_row_index, skip, take_while,
skip_while), and the unnest-and-regroup path (flat_map,
assume_hash_partition, apply_per_partition / apply_with_partition_index,
group_apply mapped over groups with torch.func.vmap, fork / fork_by /
fork_on, sliding_window), with measured exchange send slots (a slot
probe on big pure hash legs, slot feedback on every later run).

Every query runs through a lineage-tracked ``exec.recovery.Run``: stage
needs are read back once per job (the deferred settle, which replays an
overflowed stage and its dependents), lost outputs are recomputed from
their ancestors, and with ``Context(spill_dir=...)`` every stage output
is spilled as a store and a later run resumes from it.  Events go to
``Context(event_log=utils.events.EventLog(...))``.  Stores
(``Context.from_store``, ``Dataset.to_store``, ``io/store.py``) are the
JAX package's layout byte for byte, checksummed by the port's own host C
FNV-1a; ``Context.read_text`` reads local text files.

``dryad_tpu_torch.sql`` compiles SQL text into the same Dataset calls
(``sql.query(Context(), catalog, text)``); ``Dataset.check()`` and
``JobConfig(lint=...)`` run the static checker (``analysis/``), and
``plan/serialize.py`` is the JSON plan every run emits as an event.

``dryad_tpu_torch.service`` is the multi-tenant job service
(``JobService``: fair-share admission, a durable journal, SQL
submissions over a shared scan registry, standing queries, the HTTP
front end; ``python -m dryad_tpu_torch.service``), on the in-process
fleet or on worker processes that share the card
(``dryad_tpu_torch.runtime``: ``LocalCluster``, the ``TaskFarm`` with
straggler speculation, forensics bundles replayed by ``python -m
dryad_tpu_torch.obs replay``); ``python -m dryad_tpu_torch.chaos`` kills
a durable daemon and checks what its successor recovers.

``make_mesh(device, n, hosts=, pods=)`` lays the partitions out on named
axes, ``(dcn, dp)`` or ``(dcn, host, dp)``; a ``Context(mesh=...)`` on
one then plans its group-bys as one combine stage per axis, and a gang
of worker processes plans the same levels with ``dcn`` its process
boundary.  Each subpackage re-exports the names of its JAX counterpart.
"""

from dryad_tpu_torch.api.dataset import Context, Dataset  # noqa: F401
from dryad_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from dryad_tpu_torch.plan.expr import Decomposable  # noqa: F401
from dryad_tpu_torch.utils.config import JobConfig  # noqa: F401

# the release; ``__version__`` appends a digest of the package's sources
_RELEASE = "0.17.0"


def _source_digest() -> str:
    """sha256 (12 hex digits) over every Python, CUDA and C source of the
    package, with their relative paths."""
    import hashlib
    from pathlib import Path
    root = Path(__file__).resolve().parent
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.suffix in (".py", ".cu", ".cuh", ".c") \
                and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode() + b"\0"
                     + p.read_bytes())
    return h.hexdigest()[:12]


def __getattr__(name: str):
    """``__version__`` is ``<release>+<source digest>``, computed at its
    first read: any change to the port's code changes it, so the job
    service's plan-cache keys and journal records, which carry it, never
    match a plan lowered by other code."""
    if name == "__version__":
        v = f"{_RELEASE}+{_source_digest()}"
        globals()["__version__"] = v
        return v
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
