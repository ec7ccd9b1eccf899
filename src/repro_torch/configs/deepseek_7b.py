"""deepseek-7b [arXiv:2401.02954] (port of `repro.configs.deepseek_7b`):
llama-arch dense decoder, MHA (kv=32), 30L x d4096, d_ff 11008, vocab
102400. `build` (the dry-run plan) waits for the dry-run tooling."""
from repro_torch.configs.lm_common import lm_cells, lm_smoke_run
from repro_torch.models.transformer import TransformerConfig

NAME = "deepseek-7b"
FAMILY = "lm"


def full_config():
    return TransformerConfig(
        name=NAME, n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=11008, vocab=102400, rope_theta=10_000.0)


def smoke_config():
    return TransformerConfig(
        name=NAME + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=256, compute_dtype="float32", q_chunk=8, k_chunk=8)


def cells():
    return lm_cells(full_config())


def smoke_run(seed: int = 0, device=None):
    return lm_smoke_run(smoke_config(), seed, device)
