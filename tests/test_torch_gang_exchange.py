"""A rehearsal of the gang's data plane on the CPU: four gloo processes
(``torch.multiprocessing``) holding two partitions each, P = 8, run the
cases of ``tests/torch_gang_cases.py`` — the hash (int, string and
two-key), range (ascending, and descending on a string), broadcast, zip
and salted-join exchanges, the range bounds and the slot probe, and the
executor's positional ops (take, skip, with_row_index, take_while /
skip_while, sliding_window with its halo across a rank boundary,
apply_with_partition_index), a group-by + order_by and a salted join —
and each must equal the one-process P = 8 run partition by partition:
the same rows in the same order, the same NEEDs and measured slots (the
gang's all-reduce of them), bit-equal bounds, and the same stage log.
Tolerance: none.  The hash and range repartitions also equal the JAX
package's on the conftest's 8 virtual CPU devices, as a multiset per
partition.  The hierarchical aggregation's two hops on the (dcn, dp)
mesh run too: the ``dp`` hop stages no collective at all."""

import collections
import os
import socket

import pytest
import torch
import torch.multiprocessing as mp

from dryad_tpu_torch.parallel.mesh import Mesh
from tests import torch_gang_cases as cases
from tests.torch_threads import one_torch_thread  # noqa: F401

L = cases.P // cases.WORLD


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the one-process results, each rank's results)."""
    import pickle
    out = tmp_path_factory.mktemp("gang")
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        mp.spawn(cases.rank_main, args=(cases.WORLD, _free_port(), str(out)),
                 nprocs=cases.WORLD, join=True)
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old
    ranks = []
    for r in range(cases.WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    one = cases.run_cases(Mesh(torch.device("cpu"), cases.P))
    return one, ranks


EXCHANGES = ["hash_k", "hash_s", "hash_sk", "hash_needs", "axis_dp",
             "axis_dcn", "range_k",
             "range_s_desc", "broadcast", "broadcast_short", "zip",
             "salted", "probe"]
QUERIES = ["q_hash", "q_range", "q_take", "q_skip", "q_row_index",
           "q_take_while", "q_skip_while", "q_window", "q_part_index",
           "q_hash_part_index", "q_group_order", "q_salted_join"]


def _gang_parts(ranks, name):
    """Every partition's rows in global order from the ranks' results (a
    case's ``parts`` list may hold several PData's partitions in a row:
    rank r's block b is partitions [r*L, (r+1)*L) of PData b)."""
    per_rank = [r[name]["parts"] for r in ranks]
    blocks = len(per_rank[0]) // L
    return [p for b in range(blocks) for rp in per_rank
            for p in rp[b * L:(b + 1) * L]]


@pytest.mark.parametrize("name", EXCHANGES + QUERIES)
def test_gang_equals_one_process(results, name):
    one, ranks = results
    got = _gang_parts(ranks, name)
    assert [len(p) for p in got] == [len(p) for p in one[name]["parts"]]
    assert got == one[name]["parts"]
    for r in ranks:
        assert r[name]["needs"] == one[name]["needs"]
        for key in ("bounds", "log"):
            if key in one[name]:
                assert r[name][key] == one[name][key], key


def test_cases_exercise_what_they_claim(results):
    """The cases are not vacuous: the needs case overflows both NEED
    channels, the broadcast_short one its receive side, the salted join
    salts at attempt 2, the window's halo crosses ranks (partition 1 of
    rank 0 has windows ending in partition 2), and the partition index
    runs over all eight partitions."""
    one, _ = results
    nr, nsl, su = one["hash_needs"]["needs"]
    assert nr > 0 and nsl > 0 and su > 4
    assert one["broadcast_short"]["needs"][0] > cases.N // 3
    (join,) = [e for e in one["q_salted_join"]["log"]
               if e["exchange"] == "hash" and e["exchanges"] == 2]
    assert join["salted"] and join["attempts"] == 2
    assert one["q_window"]["parts"][L - 1]
    parts = {row[2] for p in one["q_part_index"]["parts"] for row in p}
    assert len(parts) == cases.P
    assert one["q_take"]["parts"][0] and sum(
        map(len, one["q_take"]["parts"])) == 37


def test_dp_hop_stages_no_row(results):
    """On the gang's (dcn, dp) mesh the ``dp`` hop of the hierarchical
    aggregation stays inside each rank: it stages no collective, so no
    row crosses gloo (its NEEDs cross later, in the executor's one
    all-reduce of the info vector).  The ``dcn`` hop stages exactly one
    all_to_all.  Both equal the one-process run (above)."""
    _, ranks = results
    for r in ranks:
        assert r["axis_dp"]["staged"] == {"collectives": 0, "bytes": 0}
        assert r["axis_dcn"]["staged"]["collectives"] == 1
        assert r["axis_dcn"]["staged"]["bytes"] > 0
    assert any(_gang_parts(ranks, "axis_dp"))


def _multisets(parts):
    return [collections.Counter(p) for p in parts]


@pytest.mark.parametrize("name,how", [("q_hash", "hash_partition"),
                                      ("q_range", "range_partition")])
def test_gang_repartition_equals_jax(results, devices8, name, how):
    from dryad_tpu import Context as JContext
    from tests.test_torch_shuffle import _jax_numpy, _rows_per_partition
    _, ranks = results
    jpd = getattr(JContext().from_columns(cases.data(), str_max_len=8),
                  how)(["k"])._materialize()
    jrows = _rows_per_partition(*_jax_numpy(jpd))
    got = _multisets(_gang_parts(ranks, name))
    assert got == jrows
