from repro_torch.kernels.embedding_bag.ops import embedding_bag

__all__ = ["embedding_bag"]
