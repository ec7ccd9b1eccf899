"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3 family] (port of
`repro.configs.qwen3_moe_235b`): MoE decoder, 94L x d4096, 64Q/4KV heads,
per-expert d_ff 1536, 128 experts top-8, vocab 151936 (~235B total /
~22B active params; far past one card, so it runs here at smoke size).
`cells` (with the a2a train cell) and `build` wait for the tooling
slice."""
from repro_torch.configs.lm_common import lm_smoke_run
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

NAME = "qwen3-moe-235b-a22b"
FAMILY = "lm"


def full_config():
    return TransformerConfig(
        name=NAME, n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
        d_ff=1536, vocab=151936, rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8))


def smoke_config():
    return TransformerConfig(
        name=NAME + "-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=32, vocab=256, moe=MoEConfig(n_experts=8, top_k=2),
        compute_dtype="float32", q_chunk=8, k_chunk=8)


def smoke_run(seed: int = 0, device=None):
    return lm_smoke_run(smoke_config(), seed, device)
