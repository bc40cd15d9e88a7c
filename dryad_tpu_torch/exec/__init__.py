"""exec layer of the PyTorch port (see the package docstring).

The names that the JAX package's ``exec`` exports are re-exported
here lazily (``dryad_tpu_torch/_lazy.py``)."""

from dryad_tpu_torch._lazy import lazy_exports

__getattr__, __dir__, __all__ = lazy_exports(__name__, {
    "dryad_tpu_torch.exec.data": (
        "PData", "pdata_from_host", "pdata_to_host",),
    "dryad_tpu_torch.exec.executor": ("CapacityError", "Executor",),
})
