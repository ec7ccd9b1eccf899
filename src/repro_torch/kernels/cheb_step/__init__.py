from repro_torch.kernels.cheb_step.ops import cheb_residual, cheb_step, \
    cheb_step_masked

__all__ = ["cheb_step", "cheb_step_masked", "cheb_residual"]
