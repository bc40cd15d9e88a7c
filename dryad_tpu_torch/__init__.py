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
"""

__version__ = "0.1.0"

from dryad_tpu_torch.api.dataset import Context, Dataset  # noqa: F401
from dryad_tpu_torch.plan.expr import Decomposable  # noqa: F401
from dryad_tpu_torch.utils.config import JobConfig  # noqa: F401
