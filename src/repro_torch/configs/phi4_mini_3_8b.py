"""Phi-4-mini-3.8B — 32L d=3072 24H (kv=8) d_ff=8192 vocab=200064,
RoPE (partial) + SwiGLU + GQA. [arXiv:2412.08905; hf:microsoft/Phi-4-mini-instruct]"""

from repro_torch.configs import ModelConfig, register

FULL = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=200064,
    rope_fraction=0.75,  # phi4-mini partial_rotary_factor
    rope_theta=10000.0,
    tie_embeddings=True,
)

REDUCED = FULL.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab=512
)

register(FULL, REDUCED)
