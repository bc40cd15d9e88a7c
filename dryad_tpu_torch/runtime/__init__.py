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
Context's terminals), the exchanges crossing processes over gloo.  The
SSH backend and the cluster's streamed runtime are ROADMAP Queue 1 items
11b.5 and 11b.6.
"""

from dryad_tpu_torch.runtime.cluster import (ClusterJobError, LocalCluster,
                                             WorkerFailure)
from dryad_tpu_torch.runtime.interfaces import (ClusterBackend,
                                                cluster_backends,
                                                make_cluster,
                                                register_cluster)
from dryad_tpu_torch.runtime.sources import DeferredSource

# the built-in backend registers here (Interfaces.cs:545 role): "local"
# = worker processes on this box
register_cluster("local", LocalCluster)

__all__ = ["LocalCluster", "WorkerFailure", "ClusterJobError",
           "DeferredSource", "ClusterBackend", "register_cluster",
           "make_cluster", "cluster_backends"]
