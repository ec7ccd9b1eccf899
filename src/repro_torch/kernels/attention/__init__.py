"""LM attention: a fused forward and FlashAttention-2's backward as CUDA
kernels (`ops.attention`), with the port's tile loop as the plain
version (`ref.chunked_attention_ref`)."""
