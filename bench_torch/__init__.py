"""The benchmark of the PyTorch / CUDA port (``python3 bench_torch/run.py``).

Kept apart from the program: nothing here is imported by the port, and
nothing here imports JAX or the JAX package."""
