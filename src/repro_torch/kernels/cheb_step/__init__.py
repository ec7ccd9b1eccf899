from repro_torch.kernels.cheb_step.ops import cheb_step

__all__ = ["cheb_step"]
