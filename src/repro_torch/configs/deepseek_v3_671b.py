"""DeepSeek-V3-671B — 61L d=7168, MLA (128 heads), 1 shared + 256 routed
experts top-8, d_ff_expert=2048, MTP. [arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3]

Faithful structural details kept: first 3 layers dense (d_ff=18432), MLA with
q_lora=1536 / kv_lora=512 / qk_nope=128 / qk_rope=64 / v=128, MTP flag.
"""

from repro_torch.configs import ModelConfig, register

FULL = ModelConfig(
    name="deepseek-v3-671b",
    family="mla_moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,  # v head dim; attention q/k use nope+rope dims below
    d_ff=18432,  # dense layers (first_k_dense)
    d_ff_expert=2048,
    vocab=129280,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    first_k_dense=3,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mtp=True,
    rope_theta=10000.0,
    capacity_factor=1.25,
)

REDUCED = FULL.replace(
    n_layers=3,  # 1 dense + 2 MoE (first_k_dense=1)
    first_k_dense=1,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=512,
    d_ff_expert=128,
    vocab=512,
    n_experts=8,
    top_k=2,
    n_shared_experts=1,
    q_lora_rank=64,
    kv_lora_rank=32,
    qk_nope_dim=32,
    qk_rope_dim=16,
    v_head_dim=32,
    mtp=True,
)

register(FULL, REDUCED)
