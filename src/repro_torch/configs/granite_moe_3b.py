"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0 family] (port of
`repro.configs.granite_moe_3b`): MoE decoder, 32L x d1536, 24Q/8KV heads,
per-expert d_ff 512, 40 experts top-8, vocab 49155."""
from repro_torch.configs.lm_common import build_lm_plan, lm_cells, \
    lm_smoke_run
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

NAME = "granite-moe-3b-a800m"
FAMILY = "lm"


def full_config():
    return TransformerConfig(
        name=NAME, n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab=49155, rope_theta=10_000.0,
        moe=MoEConfig(n_experts=40, top_k=8))


def smoke_config():
    return TransformerConfig(
        name=NAME + "-smoke", n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=256, moe=MoEConfig(n_experts=8, top_k=2),
        compute_dtype="float32", q_chunk=8, k_chunk=8)


def cells():
    return lm_cells(full_config())


def build(shape: str, multi_pod: bool):
    return build_lm_plan(full_config(), shape, multi_pod)


def smoke_run(seed: int = 0, device=None):
    return lm_smoke_run(smoke_config(), seed, device)
