"""data layer of the PyTorch port (see the package docstring).

The names that the JAX package's ``data`` exports are re-exported
here lazily (``dryad_tpu_torch/_lazy.py``)."""

from dryad_tpu_torch._lazy import lazy_exports

__getattr__, __dir__, __all__ = lazy_exports(__name__, {
    "dryad_tpu_torch.data.columnar": (
        "Batch", "Schema", "StringColumn", "batch_from_numpy",
        "batch_to_numpy", "concat_batches", "string_column_from_list",
        "string_column_to_list",),
})
