"""Logical partition mesh on one device.

The JAX package spreads partitions over a device mesh (one partition per
device, ``dryad_tpu/parallel/mesh.py``) and its CPU tests make eight
virtual devices so P = 8 runs on one host.  The port does the same on one
CUDA card: a ``Mesh`` is ``nparts`` LOGICAL partitions that all live in
one device's memory.  Every stacked tensor is ``[P, cap, ...]`` — the
JAX ``PData`` layout — and an ``all_to_all`` becomes a
``[P_src, P_dst, ...] -> [P_dst, P_src, ...]`` permute in device memory
(``parallel/shuffle.py``).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Mesh", "resolve_device"]


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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``nparts`` logical partitions on ``device``."""

    device: torch.device
    nparts: int

    def __post_init__(self):
        if self.nparts < 1:
            raise ValueError(f"nparts must be >= 1, got {self.nparts}")
