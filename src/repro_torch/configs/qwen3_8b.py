"""Qwen3-8B — the paper's second evaluation family (Table 1).
36L d=4096 32H (kv=8) d_ff=12288 vocab=151936."""

from repro_torch.configs import ModelConfig, register

FULL = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab=151936,
    rope_theta=1000000.0,
)

REDUCED = FULL.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab=512
)

register(FULL, REDUCED)
