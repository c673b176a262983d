"""InternLM2-1.8B — 24L d=2048 16H (kv=8) d_ff=8192 vocab=92544, GQA.
[arXiv:2403.17297; hf:internlm/internlm2-1_8b]"""

from repro_torch.configs import ModelConfig, register

FULL = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92544,
    rope_theta=1000000.0,
)

REDUCED = FULL.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab=512
)

register(FULL, REDUCED)
