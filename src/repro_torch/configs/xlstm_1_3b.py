"""xlstm-1.3b — sLSTM and mLSTM blocks (arXiv:2405.04517), 7:1 interleave.

d_ff=0: xLSTM blocks carry their own 2x up-projection (proj_factor).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, slstm_every=8, proj_factor=2.0,
)

SMOKE = ArchConfig(
    name="xlstm-smoke", family="ssm",
    n_layers=3, d_model=32, n_heads=2, n_kv_heads=2, d_ff=0,
    vocab=128, slstm_every=3, proj_factor=2.0, dtype="float32",
)
