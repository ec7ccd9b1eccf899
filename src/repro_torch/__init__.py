"""PyTorch/CUDA port of the CPAA PageRank system (`repro`, the JAX
reference, stays beside it).

The port mirrors `repro`'s layout and names, imports `torch` and numpy and
never `jax` or `repro`, and runs its entry points on CUDA unless the caller
passes `device="cpu"`. The TPU (Pallas) kernels on its path are
hand-written CUDA kernels for Hopper under `repro_torch/kernels/`.
"""
