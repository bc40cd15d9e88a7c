"""parallel layer of the PyTorch port (see the package docstring).

The names that the JAX package's ``parallel`` exports are re-exported
here lazily (``dryad_tpu_torch/_lazy.py``)."""

from dryad_tpu_torch._lazy import lazy_exports

__getattr__, __dir__, __all__ = lazy_exports(__name__, {
    "dryad_tpu_torch.parallel": ("mesh", "shuffle",),
})
