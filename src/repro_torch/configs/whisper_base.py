"""Whisper-base — enc-dec, 6+6L d=512 8H d_ff=2048 vocab=51865.
[arXiv:2212.04356; hf:openai/whisper-base]

The conv/mel frontend is a stub, as in the reference: a request carries
precomputed frame embeddings (n_frames=1500, d_model) for the encoder. The
decoder is a causal transformer with cross-attention and sinusoidal
positions (no RoPE).
"""

from repro_torch.configs import ModelConfig, register

FULL = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,  # decoder layers
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab=51865,
    n_frames=1500,
    rope_theta=0.0,  # sinusoidal positions, not RoPE
)

REDUCED = FULL.replace(
    n_layers=2, n_enc_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    head_dim=32, d_ff=256, vocab=512, n_frames=32,
)

register(FULL, REDUCED)
