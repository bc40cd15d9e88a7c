"""io layer of the PyTorch port: the local store and the text provider
(see the package docstring)."""
