"""h2o-danube-1.8b [arXiv:2401.16818] (port of
`repro.configs.h2o_danube_1_8b`): llama+mistral mix with sliding-window
attention. 24L x d2560, 32Q/8KV heads, d_ff 6912, vocab 32000, window
4096."""
from repro_torch.configs.lm_common import build_lm_plan, lm_cells, \
    lm_smoke_run
from repro_torch.models.transformer import TransformerConfig

NAME = "h2o-danube-1.8b"
FAMILY = "lm"


def full_config():
    return TransformerConfig(
        name=NAME, n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
        d_ff=6912, vocab=32000, sliding_window=4096, rope_theta=10_000.0)


def smoke_config():
    return TransformerConfig(
        name=NAME + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=256, sliding_window=8, compute_dtype="float32",
        q_chunk=8, k_chunk=8)


def cells():
    return lm_cells(full_config())


def build(shape: str, multi_pod: bool):
    return build_lm_plan(full_config(), shape, multi_pod)


def smoke_run(seed: int = 0, device=None):
    return lm_smoke_run(smoke_config(), seed, device)
