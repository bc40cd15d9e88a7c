"""The comparison that decides ``correct`` fails what it must: the
control (the reference one step below the configuration's precision, in
the program's place), and a run whose timed path is broken underneath.
The CPU tests run at tiny sizes; the ``card`` test at the cells' own
sizes on three seeds."""

import time

import pytest
import torch
from conftest import TINY

from portbench import bench, control

CELLS = sorted(TINY)
SEEDS = (11, 2**31 + 13, 2**40 + 17)
# the one-lane control ties keys that share their first 4 bytes: 95**4
# prefixes, so a few hundred ties need some 2 x 10^5 records
CONTROL_SIZE = dict(TINY, **{"terasort.100b": {"records": 200_000}})


def fails(cell, nums):
    return any(nums[k] > cell.reference.LIMITS[k] for k in nums)


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_tiny(cell_name, seed):
    cell = bench.Cell(cell_name, overrides=CONTROL_SIZE[cell_name])
    assert fails(cell, control.readings(cell, seed, "cpu"))


@pytest.mark.card
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_at_cell_size(card, cell_name):
    cell = bench.Cell(cell_name)
    for seed in SEEDS:
        assert fails(cell, control.readings(cell, seed, card))
        torch.cuda.empty_cache()


def run_broken(cell_name):
    cell = bench.Cell(cell_name, overrides=TINY[cell_name])
    return bench.run(cell, 2**35 + 1, 0.3, False, "cpu",
                     time.perf_counter())


def alter_answer(monkeypatch):
    """An answer altered where it is produced: the first row's revenue of
    every collected answer, or one key byte of every cached output."""
    from dryad_tpu_torch.api import dataset
    collect, cache = dataset.Dataset.collect, dataset.Dataset.cache

    def bad_collect(self):
        out = collect(self)
        out["revenue"] = out["revenue"].copy()
        out["revenue"][0] += 1
        return out

    def bad_cache(self):
        out = cache(self)
        out.node.data.batch.columns["key"].data[0, 0, 0] ^= 1
        return out

    monkeypatch.setattr(dataset.Dataset, "collect", bad_collect)
    monkeypatch.setattr(dataset.Dataset, "cache", bad_cache)


def half_left_out(monkeypatch):
    """Half of every source's rows left out."""
    from dryad_tpu_torch.api import dataset
    from_pdata = dataset.Context.from_pdata

    def half(self, pd, *a, **kw):
        pd.batch.count = pd.batch.count // 2
        return from_pdata(self, pd, *a, **kw)

    monkeypatch.setattr(dataset.Context, "from_pdata", half)


def exchange_left_out(monkeypatch):
    """Every exchange keeps each row on its own partition."""
    from dryad_tpu_torch.parallel import shuffle
    orig = shuffle.exchange_by_dest

    def stay(parts, dests, *a, **kw):
        return orig(parts, [torch.full_like(d, p)
                            for p, d in enumerate(dests)], *a, **kw)

    monkeypatch.setattr(shuffle, "exchange_by_dest", stay)


def state_unchanged(monkeypatch):
    """The job's step returns its input unchanged: the sort's output is
    its input; the join report's answer is its first groups, unsorted."""
    from dryad_tpu_torch.api import dataset
    monkeypatch.setattr(dataset.Dataset, "order_by", lambda self, keys: self)


FAULTS = {"answer_altered": alter_answer, "half_left_out": half_left_out,
          "exchange_left_out": exchange_left_out,
          "state_unchanged": state_unchanged}


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(monkeypatch, cell_name, fault):
    FAULTS[fault](monkeypatch)
    res = run_broken(cell_name)
    assert res["correct"] is False


def test_q3_order_outside_top_left_out_is_not_correct(monkeypatch):
    """A join that drops the lineitems of one qualifying order outside
    the top 10 leaves every answer right; the stage counts catch it."""
    name, seed = "tpch.q3", 2**35 + 1
    cell = bench.Cell(name, overrides=TINY[name])
    params = cell.traffic["params"]
    tables = cell.gen.make(cell.config, cell.traffic["reads"], seed,
                           torch.device("cpu"))
    (okey, _d, _p, rev), _sizes = cell.reference.revenue_by_order(tables,
                                                                   params)
    key = int(okey[rev.argmin()])
    assert key not in cell.reference.reference(tables, params)["top"][
        "l_orderkey"]
    from dryad_tpu_torch.api import dataset
    join = dataset.Dataset.join

    def bad_join(self, other, left, right, **kw):
        if left == ["l_orderkey"]:
            self = self.where(lambda c: c["l_orderkey"] != key)
        return join(self, other, left, right, **kw)

    monkeypatch.setattr(dataset.Dataset, "join", bad_join)
    res = bench.run(cell, seed, 0.3, False, "cpu", time.perf_counter())
    nums = {k: v["value"] for k, v in res["checks"].items()}
    assert res["correct"] is False
    assert nums["q3_rows_wrong"] == 0 and nums["q3_revenue_gap"] == 0
    assert nums["q3_join_rows_gap"] > 0 and nums["q3_groups_gap"] == 1
