"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3 family] (port of
`repro.configs.qwen3_moe_235b`): MoE decoder, 94L x d4096, 64Q/4KV heads,
per-expert d_ff 1536, 128 experts top-8, vocab 151936 (~235B total /
~22B active params). Its f32 weights do not fit one card: at full width
it runs cut in depth (`cell_config` at 2 of 94 layers fits), and its
smoke config runs anywhere.

`cells` adds one extra cell to the four assigned: `train_4k_a2a`, the
train_4k step with the all-to-all expert dispatch. `cell_config` gives a
cell's model config and shape; `build` is its dry-run plan, with bf16
AdamW moments and 16 microbatches at train_4k."""
import dataclasses

from repro_torch.configs.base import Cell
from repro_torch.configs.lm_common import build_lm_plan, lm_cells, \
    lm_smoke_run
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optimizer import AdamWConfig

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


def cells():
    # +1 EXTRA cell beyond the 4 assigned: the all-to-all expert dispatch
    return lm_cells(full_config()) + [Cell(shape="train_4k_a2a", kind="train",
                                           extra=True)]


def cell_config(shape: str) -> tuple[TransformerConfig, str]:
    """(model config, LM shape) of cell `shape`: train_4k_a2a is
    full_config() with the all-to-all MoE (impl "a2a") at train_4k; the
    other cells are full_config() at their own shape."""
    cfg = full_config()
    if shape == "train_4k_a2a":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl="a2a"))
        shape = "train_4k"
    return cfg, shape


def build(shape: str, multi_pod: bool):
    opt = AdamWConfig(m_dtype="bfloat16", v_dtype="bfloat16")
    cfg, shape = cell_config(shape)
    return build_lm_plan(cfg, shape, multi_pod, opt_cfg=opt,
                         num_microbatches=16 if shape == "train_4k" else None)


def smoke_run(seed: int = 0, device=None):
    return lm_smoke_run(smoke_config(), seed, device)
