"""OLMoE-1B-7B — 16L d=2048 16H (kv=16) MoE 64 experts top-8, d_ff_expert=1024.
[arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924]"""

from repro_torch.configs import ModelConfig, register

FULL = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,  # unused for MoE layers; kept for reporting
    d_ff_expert=1024,
    vocab=50304,
    n_experts=64,
    top_k=8,
    rope_theta=10000.0,
)

REDUCED = FULL.replace(
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=64,
    d_ff_expert=64,
    vocab=512,
    n_experts=8,
    top_k=2,
)

register(FULL, REDUCED)
