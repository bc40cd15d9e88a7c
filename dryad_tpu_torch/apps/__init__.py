"""apps layer of the PyTorch port (see the package docstring)."""

from dryad_tpu_torch.apps import (groupbyreduce, pagerank,  # noqa: F401
                                  terasort, wordcount)
