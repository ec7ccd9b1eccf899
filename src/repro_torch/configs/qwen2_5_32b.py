"""qwen2.5-32b [hf:Qwen/Qwen2.5 family] (port of
`repro.configs.qwen2_5_32b`): dense decoder, GQA (40Q/8KV), QKV bias,
64L x d5120, d_ff 27648, vocab 152064. Its f32 weights (131 GB) do not fit
one card; it runs here at smoke size. `build` (the dry-run plan) waits
for the dry-run tooling."""
from repro_torch.configs.lm_common import lm_cells, lm_smoke_run
from repro_torch.models.transformer import TransformerConfig

NAME = "qwen2.5-32b"
FAMILY = "lm"


def full_config():
    return TransformerConfig(
        name=NAME, n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=27648, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0)


def smoke_config():
    return TransformerConfig(
        name=NAME + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=256, qkv_bias=True, compute_dtype="float32",
        q_chunk=8, k_chunk=8)


def cells():
    return lm_cells(full_config())


def smoke_run(seed: int = 0, device=None):
    return lm_smoke_run(smoke_config(), seed, device)
