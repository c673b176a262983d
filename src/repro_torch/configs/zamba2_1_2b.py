"""Zamba2-1.2B — 38 Mamba2 blocks d=2048 (ssm_state=64) + a shared full
attention/MLP block (32H, d_ff=8192) invoked every 6 blocks on
concat(hidden, embed0), with a per-invocation adapter.
[arXiv:2411.15242; hf:Zyphra/Zamba2-1.2B]
"""

from repro_torch.configs import ModelConfig, register

FULL = ModelConfig(
    name="zamba2-1.2b",
    family="mamba_hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,  # shared attention block: 2*d_model concat input, 64-dim heads
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_head_dim=64,
    shared_attn_every=6,
)

REDUCED = FULL.replace(
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=256,
    vocab=512, ssm_state=16, ssm_head_dim=32, shared_attn_every=2,
)

register(FULL, REDUCED)
