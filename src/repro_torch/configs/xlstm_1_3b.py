"""xLSTM-1.3B — 48 blocks d=2048, mLSTM (4 heads) with periodic sLSTM blocks.
[arXiv:2405.04517]

d_ff=0: blocks carry their own up/down projections (proj_factor 2 for
mLSTM). Sub-quadratic: its recurrent state does not grow with the context.
"""

from repro_torch.configs import ModelConfig, register

FULL = ModelConfig(
    name="xlstm-1.3b",
    family="xlstm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,  # d_inner(4096) / heads(4) after proj_factor 2 — per-block
    d_ff=0,
    vocab=50304,
    slstm_every=8,  # every 8th block is sLSTM (7:1 mLSTM:sLSTM, paper's ratio)
    xlstm_proj_factor=2.0,
)

REDUCED = FULL.replace(
    n_layers=4, d_model=128, n_heads=2, n_kv_heads=2, head_dim=128,
    vocab=512, slstm_every=2,
)

register(FULL, REDUCED)
