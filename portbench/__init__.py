"""The benchmark of the PyTorch / CUDA port (see BENCHMARK.json)."""
