"""Logical partition mesh: one process's partitions on its device, and
the gang's collectives.

The JAX package spreads partitions over a device mesh (one partition per
device, ``dryad_tpu/parallel/mesh.py``) and its CPU tests make eight
virtual devices so P = 8 runs on one host.  The port does the same on one
CUDA card: a ``Mesh`` is ``nparts`` LOGICAL partitions.  Every stacked
tensor is ``[P, cap, ...]`` — the JAX ``PData`` layout — and an
``all_to_all`` inside one process is a ``[P_src, P_dst, ...] ->
[P_dst, P_src, ...]`` permute in device memory (``parallel/shuffle.py``).

A gang (``runtime/exec_common.py``: one plan run SPMD by every worker
process) spreads the ``nparts`` partitions over ``world`` processes:
rank r holds the partitions ``[r * local_nparts, (r + 1) * local_nparts)``
on its own device context, and the exchanges cross processes through the
collectives below.  They are host-staged over gloo (the
``torch.distributed`` process group the worker joined): each copies its
device tensor to host memory, runs the gloo collective and copies the
result back.  gloo runs the same on a CPU-only host and beside several
processes on one card, where NCCL cannot place two ranks.  On a
one-process mesh (``world == 1``) every collective returns its input:
no copy, no launch, no host sync.

The partitions carry named axes, outermost first, as the JAX package's
device meshes do: ``("dp",)``, ``("dcn", "dp")`` or ``("dcn", "host",
"dp")`` (``make_mesh``).  A partition's index is mixed-radix over the
axes, innermost least significant: partition = dcn_index * |dp| +
dp_index on ``(dcn, dp)``.  The axes name the levels of the
hierarchical aggregation (``plan/planner.py``: one combine stage per
axis, innermost first) and the axis of each of its exchanges
(``shuffle.hash_exchange(axis=)``).  On a gang the outermost axis is
``dcn`` and its index is the rank: the ``dp`` axis stays inside a
process.

``STAGED`` counts the staged collectives of this process: their number,
the bytes each moved, the host syncs (one a collective: its
device-to-host read), and the seconds of the device-to-host copy, the
gloo call and the host-to-device copy (the read waits for the device's
queued work first, so that wait is timed apart as ``wait_s``; the
host-to-device copy is timed as enqueued).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Tuple

import torch

__all__ = ["PARTITION_AXIS", "MID_AXIS", "HOST_AXIS", "Mesh", "make_mesh",
           "mesh_axes", "axis_sizes", "resolve_device", "STAGED"]

PARTITION_AXIS = "dp"
MID_AXIS = "host"
HOST_AXIS = "dcn"

# this process's staged-collective totals (see the module docstring)
STAGED: Dict[str, float] = dict(collectives=0, host_syncs=0, bytes=0,
                                wait_s=0.0, d2h_s=0.0, gloo_s=0.0,
                                h2d_s=0.0)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller asks for
    the CPU; asking for CUDA on a machine without it raises instead of
    quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dryad_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def make_mesh(device="cuda", n: int = 8, hosts: int | None = None,
              pods: int | None = None) -> "Mesh":
    """``n`` logical partitions on ``device`` (CUDA unless the caller asks
    for the CPU), as the JAX package's ``make_mesh`` lays its devices
    out: ``(dp,)``; with ``hosts`` > 1, ``(dcn, dp)`` — ``hosts`` rows of
    ``n / hosts`` partitions; with ``pods`` > 1 too, ``(dcn, host, dp)``
    — ``pods`` x ``hosts`` x ``n / (pods * hosts)``."""
    dev = resolve_device(device)
    if pods and pods > 1:
        if not hosts or hosts < 1:
            raise ValueError("pods > 1 needs hosts (hosts per pod)")
        if n % (pods * hosts):
            raise ValueError(f"{n} devices not divisible by "
                             f"{pods} pods x {hosts} hosts")
        return Mesh(dev, n, axes=((HOST_AXIS, pods), (MID_AXIS, hosts),
                                  (PARTITION_AXIS, n // (pods * hosts))))
    if hosts and hosts > 1:
        if n % hosts:
            raise ValueError(f"{n} devices not divisible by {hosts} hosts")
        return Mesh(dev, n, axes=((HOST_AXIS, hosts),
                                  (PARTITION_AXIS, n // hosts)))
    return Mesh(dev, n)


def mesh_axes(mesh: "Mesh") -> tuple:
    """All partition axes of the mesh, outermost first."""
    return mesh.axis_names


def axis_sizes(mesh: "Mesh") -> dict:
    return dict(mesh.axes)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``nparts`` logical partitions over ``world`` processes, this one
    being ``rank`` and holding ``local_nparts`` of them on ``device``.
    ``group`` is the gang's ``torch.distributed`` process group (None:
    the default group).  ``axes`` names the partition axes with their
    sizes, outermost first (default: ``(("dp", nparts),)`` in one
    process, ``(("dcn", world), ("dp", local_nparts))`` on a gang); a
    gang's outermost axis is ``("dcn", world)``."""

    device: torch.device
    nparts: int
    rank: int = 0
    world: int = 1
    group: Any = dataclasses.field(default=None, compare=False)
    axes: Tuple[Tuple[str, int], ...] = ()

    def __post_init__(self):
        if self.nparts < 1:
            raise ValueError(f"nparts must be >= 1, got {self.nparts}")
        if not 0 <= self.rank < self.world or self.nparts % self.world:
            raise ValueError(f"rank {self.rank} of world {self.world} "
                             f"cannot hold {self.nparts} partitions")
        axes = tuple((str(n), int(z)) for n, z in self.axes) or (
            ((PARTITION_AXIS, self.nparts),) if self.world == 1 else
            ((HOST_AXIS, self.world),
             (PARTITION_AXIS, self.nparts // self.world)))
        object.__setattr__(self, "axes", axes)
        names = [n for n, _ in axes]
        if len(set(names)) != len(names) or math.prod(
                z for _, z in axes) != self.nparts:
            raise ValueError(f"mesh axes {axes} do not make "
                             f"{self.nparts} partitions")
        if self.world > 1 and axes[0] != (HOST_AXIS, self.world):
            raise ValueError(f"a gang mesh's outermost axis is "
                             f"({HOST_AXIS!r}, {self.world}), not "
                             f"{axes[0]}")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The partition axes, outermost first."""
        return tuple(n for n, _ in self.axes)

    def axis_size(self, axis: str) -> int:
        return dict(self.axes)[axis]

    def axis_radix(self, axis: str) -> int:
        """The product of the sizes of the axes inside ``axis``: a
        partition's coordinate on it is ``(index // radix) % size``."""
        radix = 1
        for n, z in reversed(self.axes):
            if n == axis:
                return radix
            radix *= z
        raise ValueError(f"mesh has no axis {axis!r} (axes "
                         f"{self.axis_names})")

    @property
    def local_nparts(self) -> int:
        return self.nparts // self.world

    @property
    def part_start(self) -> int:
        """The global index of this process's first partition."""
        return self.rank * self.local_nparts

    @property
    def gang(self) -> bool:
        return self.world > 1

    # -- collectives (the identity at world 1) -----------------------------

    def _staged(self, x: torch.Tensor, call) -> torch.Tensor:
        """Run ``call(host_in) -> host_out`` on a host copy of ``x`` and
        bring the result back to ``x``'s device, timing each step."""
        cuda = x.device.type == "cuda"
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.synchronize(x.device)
        t1 = time.perf_counter()
        h = x.contiguous().cpu()
        t2 = time.perf_counter()
        out = call(h)
        t3 = time.perf_counter()
        res = out.to(x.device)
        t4 = time.perf_counter()
        STAGED["collectives"] += 1
        STAGED["host_syncs"] += 1
        STAGED["bytes"] += h.numel() * h.element_size()
        STAGED["wait_s"] += t1 - t0
        STAGED["d2h_s"] += t2 - t1
        STAGED["gloo_s"] += t3 - t2
        STAGED["h2d_s"] += t4 - t3
        return res

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` is [world, ...]: block r goes to rank r; returns
        [world, ...] whose block s came from rank s."""
        if not self.gang:
            return x
        import torch.distributed as dist

        def call(h):
            out = torch.empty_like(h)
            dist.all_to_all_single(out, h, group=self.group)
            return out
        return self._staged(x, call)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[world, *x.shape]: every rank's ``x`` in rank order."""
        if not self.gang:
            return x[None]
        import torch.distributed as dist

        def call(h):
            out = torch.empty((self.world,) + tuple(h.shape), dtype=h.dtype)
            dist.all_gather(list(out.unbind(0)), h, group=self.group)
            return out
        return self._staged(x, call)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of every rank's ``x`` (the gang's NEEDs,
        slots and per-partition rows: each rank's at its place, zeros
        elsewhere)."""
        if not self.gang:
            return x
        import torch.distributed as dist

        def call(h):
            dist.all_reduce(h, op=dist.ReduceOp.MAX, group=self.group)
            return h
        return self._staged(x, call)

    def from_next(self, x: torch.Tensor) -> torch.Tensor:
        """The neighbour send: every rank sends ``x`` to rank - 1 and
        gets rank + 1's (the last rank gets zeros).  The sliding window's
        halo crosses a rank boundary this way."""
        if not self.gang:
            return torch.zeros_like(x)
        import torch.distributed as dist

        def call(h):
            out = torch.zeros_like(h)
            ops = []
            if self.rank > 0:
                ops.append(dist.P2POp(dist.isend, h, self.rank - 1,
                                      group=self.group))
            if self.rank < self.world - 1:
                ops.append(dist.P2POp(dist.irecv, out, self.rank + 1,
                                      group=self.group))
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            return out
        return self._staged(x, call)

    def place(self, local: torch.Tensor) -> torch.Tensor:
        """A [local_nparts, ...] per-partition vector at its place in a
        zero [nparts, ...] one, so that an all-reduce (max) of every
        rank's gathers the global vector.  The identity at world 1."""
        if not self.gang:
            return local
        out = local.new_zeros((self.nparts,) + tuple(local.shape[1:]))
        out[self.part_start:self.part_start + self.local_nparts] = local
        return out

    def gather_parts(self, local: torch.Tensor) -> torch.Tensor:
        """Every partition's [local_nparts, ...] values, concatenated in
        partition order: [nparts, ...] (rank order is partition order)."""
        if not self.gang:
            return local
        g = self.all_gather(local)
        return g.reshape((self.nparts,) + tuple(local.shape[1:]))

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This process's slice of a per-partition [nparts, ...] vector."""
        if not self.gang:
            return full
        return full[self.part_start:self.part_start + self.local_nparts]
