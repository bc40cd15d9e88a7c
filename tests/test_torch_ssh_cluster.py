"""The SSH submission backend (``runtime/ssh_cluster.py``): the
counterparts of the 5 tests of ``tests/test_ssh_cluster.py``, on
``device="cpu"``.

No sshd here: the tests inject a LOCAL transport (``bash -c``), which
runs everything but the ssh binary — the staging goes through the
transport's stdin as it would over ssh, and the workers import the
staged copy, not the checkout.  Results are held to the port's
in-process run at the same P and to the JAX package's."""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_cluster_fns as F  # noqa: E402

from dryad_tpu import Context as JContext  # noqa: E402
from dryad_tpu_torch import Context  # noqa: E402
from dryad_tpu_torch.runtime import make_cluster  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401


def local_rsh(host, command):
    """The test transport: run the remote-shell command on this box."""
    return ["bash", "-c", command]


@pytest.fixture(scope="module")
def ssh_cluster(tmp_path_factory):
    old = {k: os.environ.get(k) for k in ("PYTHONPATH", "OMP_NUM_THREADS")}
    os.environ["OMP_NUM_THREADS"] = "1"
    root = str(tmp_path_factory.mktemp("ssh-stage"))
    # the workers import the test module for the shipped UDFs; the
    # STAGED package provides dryad_tpu_torch itself
    cl = make_cluster(
        "ssh", hosts=["nodeA", "nodeB"], devices_per_process=2,
        driver_host="127.0.0.1", coordinator_host="127.0.0.1",
        python=sys.executable, remote_root=root, device="cpu",
        remote_pythonpath=[HERE], rsh=local_rsh,
        fn_modules=("torch_cluster_fns",))
    yield cl, root
    cl.shutdown()
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_ssh_staging_and_gang(ssh_cluster):
    """The code is staged into the root (sources only: the kernels'
    ``.cu`` files, no JAX package, nothing built), the 2 x 2 gang forms,
    its workers import the staged copy, and a plan runs end to end."""
    cl, root = ssh_cluster
    pkg = os.path.join(root, "dryad_tpu_torch")
    assert os.path.isdir(os.path.join(pkg, "runtime"))
    cus = sorted(f for f in os.listdir(os.path.join(pkg, "ops", "csrc"))
                 if f.endswith(".cu"))
    assert cus == ["hash_keys.cu", "hist_buckets.cu", "prefix_sum.cu",
                   "prefix_sum2.cu", "seg_scan.cu", "slot_compact.cu",
                   "slot_expand.cu"]
    assert os.path.exists(os.path.join(pkg, "ops", "csrc", "host_fnv.c"))
    assert not os.path.exists(os.path.join(root, "dryad_tpu"))
    staged = [p for d, _, fs in os.walk(pkg) for p in fs]
    assert not [p for p in staged if p.endswith(".so")]
    assert cl.stage_s > 0
    ctx = Context(cluster=cl)
    n = 4000
    rng = np.random.RandomState(4)
    data = {"k": rng.randint(0, 20, n).astype(np.int32),
            "v": rng.randint(-100, 100, n).astype(np.int32)}

    def q(c):
        return c.from_columns(data).group_by(
            ["k"], {"s": ("sum", "v"), "n": ("count", None)})
    out = q(ctx).select(F.in_staged_copy).collect()
    ref = q(Context(device="cpu", nparts=4)).collect()
    jref = q(JContext()).collect()
    for other in (ref, jref):
        assert sorted(zip(out["k"].tolist(), out["s"].tolist(),
                          out["n"].tolist())) == sorted(zip(
            np.asarray(other["k"]).tolist(), np.asarray(other["s"]).tolist(),
            np.asarray(other["n"]).tolist()))
    assert dict(zip(out["k"].tolist(), out["s"].tolist())) == {
        int(k): int(data["v"][data["k"] == k].sum())
        for k in np.unique(data["k"])}


def test_ssh_udfs_and_scalars(ssh_cluster, tmp_path):
    """Shipped UDFs and scalar terminals through the ssh gang, and a
    streamed query (the gang's chunk waves) over a store."""
    cl, _ = ssh_cluster
    ctx = Context(cluster=cl)
    v = np.arange(1000, dtype=np.int32) - 500
    ds = (ctx.from_columns({"v": v}).select(F.double_v)
          .where(F.keep_positive))
    assert ds.count() == int((v * 2 > 0).sum())
    src = str(tmp_path / "v")
    Context(device="cpu").from_columns({"v": v}).to_store(src)
    got = ctx.read_store_stream(src, chunk_rows=64).order_by(
        [("v", False)]).collect()
    np.testing.assert_array_equal(got["v"], np.sort(v))


def test_ssh_worker_failure_replay(ssh_cluster):
    """Gang replay through the ssh control plane: kill worker 1's
    transport process; the next job replays on a fresh gang."""
    cl, _ = ssh_cluster
    ctx = Context(cluster=cl)
    v = np.arange(2000, dtype=np.int32)
    assert ctx.from_columns({"v": v}).count() == 2000
    # the remote worker dies with its transport process under bash -c;
    # under ssh the client's death severs the session the same way
    cl._procs[1].kill()
    cl._procs[1].wait()
    assert ctx.from_columns({"v": v}).sum("v") == int(v.sum())


def test_ssh_preinstalled_code(tmp_path):
    """``stage_code=False``: nothing is shipped, the workers import the
    ``dryad_tpu_torch`` that ``remote_pythonpath`` names first (here the
    checkout, standing in for a copy installed on the hosts), and the
    control secret still arrives as a 0600 file under the root."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    repo = os.path.dirname(HERE)
    root = str(tmp_path / "root")
    cl = make_cluster(
        "ssh", hosts=["nodeA", "nodeB"], devices_per_process=2,
        driver_host="127.0.0.1", coordinator_host="127.0.0.1",
        python=sys.executable, remote_root=root, stage_code=False,
        device="cpu", remote_pythonpath=[repo, HERE], rsh=local_rsh,
        fn_modules=("torch_cluster_fns",))
    try:
        assert sorted(os.listdir(root)) == [".control-secret"]
        secret = os.path.join(root, ".control-secret")
        assert os.stat(secret).st_mode & 0o777 == 0o600
        with open(secret) as f:
            assert bytes.fromhex(f.read()) == cl._secret
        v = np.arange(3000, dtype=np.int32) - 1000
        out = Context(cluster=cl).from_columns({"v": v}).select(
            F.in_staged_copy).select(F.double_v).collect()
        np.testing.assert_array_equal(np.sort(out["v"]), np.sort(v * 2))
    finally:
        cl.shutdown()
        if old is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old


def test_ssh_backend_registered():
    from dryad_tpu_torch.runtime import SshCluster, cluster_backends
    assert "ssh" in cluster_backends()
    with pytest.raises(ValueError, match="at least one host"):
        SshCluster(hosts=[])
    with pytest.raises(ValueError, match="unsupported device"):
        SshCluster(hosts=["a"], device="tpu", rsh=local_rsh)


def test_real_sshd_cluster_opt_in():
    """OPT-IN (DRYAD_SSH_TESTS=1 and passwordless ssh to localhost): the
    real ``ssh -o BatchMode`` transport — staging over ssh's stdin, the
    secret file, gang formation, an SPMD job."""
    import subprocess
    if os.environ.get("DRYAD_SSH_TESTS") != "1":
        pytest.skip("set DRYAD_SSH_TESTS=1 with passwordless ssh to "
                    "localhost to run")
    probe = subprocess.run(
        ["ssh", "-o", "BatchMode=yes", "-o", "ConnectTimeout=3",
         "127.0.0.1", "true"], capture_output=True)
    if probe.returncode != 0:
        pytest.skip("no passwordless sshd on 127.0.0.1")
    from dryad_tpu_torch.runtime.ssh_cluster import SshCluster
    cl = SshCluster(hosts=["127.0.0.1", "127.0.0.1"],
                    driver_host="127.0.0.1", coordinator_host="127.0.0.1",
                    python=sys.executable, device="cpu",
                    remote_pythonpath=[HERE])
    try:
        ctx = Context(cluster=cl)
        v = np.arange(2000, dtype=np.int32)
        assert ctx.from_columns({"v": v}).count() == 2000
        assert ctx.from_columns({"v": v}).group_by(
            ["v"], {"n": ("count", None)}).count() == 2000
    finally:
        cl.shutdown()
