from repro_torch.kernels.bsr_spmm.ops import bsr_spmm

__all__ = ["bsr_spmm"]
