from repro_torch.kernels.topk.ops import topk_columns

__all__ = ["topk_columns"]
