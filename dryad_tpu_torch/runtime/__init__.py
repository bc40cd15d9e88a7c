"""Multi-process runtime — the port of ``dryad_tpu/runtime``: the
per-node worker service, the driver-side control plane, the task farm
with straggler speculation, and plan shipping.

The counterpart of the reference's layers 2/4/5 (SURVEY.md §1): job
submission (LinqToDryad/LocalJobSubmission.cs:97-302), the cluster
interface (ClusterInterface/Interfaces.cs:324,491), and the per-node
daemon (ProcessService/ProcessService.cs:389).  Each worker runs farm
tasks on its own device (the CUDA card by default; several workers
time-share one card), and the gang's SPMD jobs across all of them
(``LocalCluster.execute``, ``exec_common.execute_plan``, a cluster
Context's terminals), the exchanges crossing processes over gloo; a
streamed query runs there as chunk waves (``stream_plan.py``).  Two
backends: "local" (worker processes on this machine) and "ssh" (one
worker per remote host over a remote shell, the code staged there,
``ssh_cluster.py``).
"""

from dryad_tpu_torch.runtime.cluster import (ClusterJobError, LocalCluster,
                                             WorkerFailure)
from dryad_tpu_torch.runtime.interfaces import (ClusterBackend,
                                                cluster_backends,
                                                make_cluster,
                                                register_cluster)
from dryad_tpu_torch.runtime.sources import DeferredSource

# the built-in backends register here (Interfaces.cs:545 role): "local"
# = worker processes on this box; "ssh" = one worker per remote host over
# a remote shell, the code staged per host (runtime/ssh_cluster.py)
register_cluster("local", LocalCluster)
from dryad_tpu_torch.runtime.ssh_cluster import SshCluster  # noqa: E402

__all__ = ["LocalCluster", "SshCluster", "WorkerFailure", "ClusterJobError",
           "DeferredSource", "ClusterBackend", "register_cluster",
           "make_cluster", "cluster_backends"]
