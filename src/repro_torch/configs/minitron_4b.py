"""minitron-4b — width-pruned nemotron (arXiv:2407.14679).
long_500k: SKIPPED (pure full attention)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=9216,
    vocab=256000, gated_mlp=False, act="gelu",
)

SMOKE = ArchConfig(
    name="minitron-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, gated_mlp=False, act="gelu", dtype="float32",
    kv_page_size=8,
)
