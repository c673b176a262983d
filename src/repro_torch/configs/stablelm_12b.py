"""StableLM-2-12B — 40L d=5120 32H (kv=8) d_ff=13824 vocab=100352, partial RoPE.
[hf:stabilityai/stablelm-2-12b]"""

from repro_torch.configs import ModelConfig, register

FULL = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab=100352,
    rope_fraction=0.25,  # stablelm-2 rotary_percent
    rope_theta=10000.0,
)

REDUCED = FULL.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab=512
)

register(FULL, REDUCED)
