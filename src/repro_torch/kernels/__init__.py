"""Hand-written Hopper kernels for the port's hot spots.

Each kernel package holds three files, as `repro.kernels` does:
  csrc/<name>.cu — the CUDA C++ kernel for sm_90a with a plain C entry
                   point (built with nvcc and loaded with ctypes by
                   `kernels/_build.py`, at first use)
  ops.py         — the wrapper: checks its inputs, launches the kernel on a
                   CUDA tensor (or raises), takes the plain version on a CPU
                   tensor, and counts its launches
  ref.py         — the plain PyTorch version, used by the CPU tests and held
                   against the kernel on the card

Kernels:
  bsr_spmm      — block-ELL sparse x dense product, the CPAA round's SpMM
  cheb_step     — fused Chebyshev update t'' = 2y - t; acc += c_k t''
  embedding_bag — bag-sum row gather out[b] = sum_l w[b,l] table[ids[b,l]],
                  the DLRM-RM2 lookup
  adamw         — one leaf's AdamW update in one pass (`adamw_step`) and
                  its sum of squares for the clip's norm (`sum_squares`),
                  on every training step
"""
