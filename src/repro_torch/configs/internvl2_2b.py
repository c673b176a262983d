"""InternVL2-2B — InternLM2-1.8B language backbone + InternViT frontend.
[arXiv:2404.16821; hf:OpenGVLab/InternVL2-2B]

The ViT frontend is a stub, as in the reference: a request carries
precomputed patch embeddings (n_patches, d_model) that the backbone prepends
to the token embeddings. vocab=92553 (padded to 92672 at the head).
"""

from repro_torch.configs import ModelConfig, register

FULL = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92553,
    n_patches=256,  # 448x448 image, patch 28 -> 256 patch embeddings
    rope_theta=1000000.0,
)

REDUCED = FULL.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
    vocab=512, n_patches=16,
)

register(FULL, REDUCED)
