"""The port's chaos harness (``dryad_tpu_torch/chaos``) against the JAX
package's, on the CPU:

* ``FaultPlan(seed)`` is the JAX plan for seeds 0-63 (the contract that
  makes a failing seed reproducible with either package);
* ``torn_tail`` / ``chop_tail`` leave the same bytes on two copies of
  one journal; ``sigkill`` of a process that is gone reports False;
* ``check_invariants`` of both packages agree on the durable directory
  the port's scenario wrote, clean and with a torn tail;
* the acceptance scenario, ``run_scenario(seed=3, device="cpu")``: a
  real victim daemon process SIGKILLed past its target job's first
  settled stage, a successor adopting the journal — ok, zero lost jobs,
  no duplicate terminal, no diverged result, at least one stage
  restored, the standing query recovered (``tests/test_durable.py``'s
  assertions).
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from dryad_tpu.chaos import faults as jfaults
from dryad_tpu.chaos import invariants as jinvariants
from dryad_tpu.chaos.plan import FaultPlan as JFaultPlan
from dryad_tpu_torch.chaos import FaultPlan, faults, invariants, \
    run_scenario
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("seed", range(64))
def test_fault_plan_equals_jax(seed):
    plan = FaultPlan(seed)
    assert plan.to_json() == JFaultPlan(seed).to_json()
    assert FaultPlan.from_json(plan.to_json()).to_json() == plan.to_json()
    assert repr(plan) == repr(JFaultPlan(seed))


def test_fault_injectors_equal_jax(tmp_path):
    body = "".join(json.dumps({"rec": "x", "n": i}) + "\n"
                   for i in range(20))
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    for p in (a, b):
        p.write_text(body)
    for nbytes in (8, 40, 120):
        faults.torn_tail(str(a), nbytes)
        jfaults.torn_tail(str(b), nbytes)
        assert a.read_bytes() == b.read_bytes()
    for nbytes in (1, 17, 0):
        faults.chop_tail(str(a), nbytes)
        jfaults.chop_tail(str(b), nbytes)
        assert a.read_bytes() == b.read_bytes()
    gone = subprocess.Popen([sys.executable, "-c", "pass"])
    gone.wait()
    assert faults.sigkill(gone.pid) is False


@pytest.fixture(scope="module")
def seed3(tmp_path_factory):
    """The acceptance scenario, once for the module."""
    d = str(tmp_path_factory.mktemp("chaos") / "seed3")
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        return run_scenario(seed=3, workdir=d, timeout=300, device="cpu")
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old


def test_chaos_sigkill_acceptance_seed3(seed3):
    report = seed3
    assert report["ok"], json.dumps(report, indent=2, default=str)
    assert report["device"] == "cpu"
    assert report["plan"] == JFaultPlan(3).to_json()
    assert report["spills_at_kill"] >= 1       # past a settled stage
    assert report["stages_restored"] >= 1      # ...which was not redone
    assert report["recovery"]["resumed"] >= 1
    assert report["recovery"]["readmitted"] >= 1
    assert report["standing_recovered"]
    inv = report["invariants"]
    assert not inv["lost"] and not inv["dup_terminals"] \
        and not inv["diverged"]


def test_invariants_agree_with_jax_clean_and_torn(seed3, tmp_path):
    """Both packages' checkers read the port's durable dir alike; a torn
    journal tail is truncated and reported by both."""
    src = os.path.join(seed3["workdir"], "svc", "durable")
    for torn in (False, True):
        got = {}
        for name, mod, fmod in (("port", invariants, faults),
                                ("jax", jinvariants, jfaults)):
            d = str(tmp_path / f"{name}-{torn}")
            shutil.copytree(src, d)
            if torn:
                fmod.torn_tail(os.path.join(d, "journal.jsonl"), 33)
            got[name] = mod.check_invariants(d)
        assert got["port"] == got["jax"]
        assert got["port"]["torn"] is torn and got["port"]["ok"]
        assert got["port"]["epochs"] >= 2 and got["port"]["jobs"] >= 3
