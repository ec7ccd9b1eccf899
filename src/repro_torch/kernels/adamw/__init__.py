from repro_torch.kernels.adamw.ops import adamw_step, sum_squares

__all__ = ["adamw_step", "sum_squares"]
