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
                  (`cheb_step`, the fixed-round solves), the adaptive
                  loop's masked round in place (`cheb_step_masked`) and
                  its chunk residual (`cheb_residual`)
  embedding_bag — bag-sum row gather out[b] = sum_l w[b,l] table[ids[b,l]],
                  the DLRM-RM2 lookup, its backward, and both over a
                  window of the table's rows (with the window backward's
                  index sort, `embedding_bag_window_sort`)
  adamw         — one leaf's AdamW update in one pass (`adamw_step`) and
                  its sum of squares for the clip's norm (`sum_squares`),
                  on every training step
  topk          — the ranked top-k down each column of [R, B]
                  (`topk_columns`, lower vertex id first on ties, through
                  an optional row map), on every PPR ranking and DLRM
                  retrieval
  attention     — LM attention: a fused forward (`attention_forward`) and
                  FlashAttention-2's deterministic backward
                  (`attention_backward`), on prefill and every LM training
                  step; each also counted by route (`_wgmma` for bf16,
                  `_ffma` for f32)

`launch_counts()` reads every kernel's launch counter, by the names above
(one list for chip_smoke.py and the dry-run); `reset_launch_counts()` sets
them all to 0.
"""
from __future__ import annotations

__all__ = ["launch_counts", "reset_launch_counts"]


def _ops() -> tuple:
    # imported here: each ops module imports this package
    from repro_torch.kernels.adamw import ops as adamw
    from repro_torch.kernels.attention import ops as attention
    from repro_torch.kernels.bsr_spmm import ops as bsr
    from repro_torch.kernels.cheb_step import ops as cheb
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.topk import ops as topk
    return adamw, attention, bsr, cheb, eb, topk


def launch_counts() -> dict:
    """{kernel: launches since the last reset}, every kernel of the port."""
    adamw, attention, bsr, cheb, eb, topk = _ops()
    return {"bsr_spmm": bsr.launches(), "cheb_step": cheb.launches(),
            "cheb_step_masked": cheb.masked_launches(),
            "cheb_residual": cheb.residual_launches(),
            "topk_columns": topk.launches(),
            "embedding_bag": eb.launches(),
            "embedding_bag_backward": eb.backward_launches(),
            "embedding_bag_window": eb.window_launches(),
            "embedding_bag_window_backward": eb.window_backward_launches(),
            "embedding_bag_window_sort": eb.window_sort_launches(),
            "adamw_step": adamw.step_launches(),
            "sum_squares": adamw.norm_launches(),
            "attention_forward": attention.forward_launches(),
            "attention_backward": attention.backward_launches(),
            **{f"attention_{k}": n
               for k, n in attention.launches_by_route().items()}}


def reset_launch_counts() -> None:
    """Set every kernel's launch counters to 0 (the by-variant counts and
    AdamW's copy count with them)."""
    for mod in _ops():
        mod.reset_launches()
