"""io layer of the PyTorch port: the local store and the text provider
(see the package docstring).

The names that the JAX package's ``io`` exports are re-exported
here lazily (``dryad_tpu_torch/_lazy.py``)."""

from dryad_tpu_torch._lazy import lazy_exports

__getattr__, __dir__, __all__ = lazy_exports(__name__, {
    "dryad_tpu_torch.io.store": ("read_store", "store_meta", "write_store",),
})
