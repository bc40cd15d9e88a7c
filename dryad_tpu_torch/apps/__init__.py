"""apps layer of the PyTorch port (see the package docstring)."""

from dryad_tpu_torch.apps import (groupbyreduce, kmeans,  # noqa: F401
                                  pagerank, terasort, wordcount)
