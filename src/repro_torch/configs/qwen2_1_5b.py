"""Qwen2-1.5B — 28L d=1536 12H (kv=2) d_ff=8960 vocab=151936, GQA + QKV bias.
[arXiv:2407.10671; hf:Qwen/Qwen2-1.5B]"""

from repro_torch.configs import ModelConfig, register

FULL = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
)

REDUCED = FULL.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab=512
)

register(FULL, REDUCED)
