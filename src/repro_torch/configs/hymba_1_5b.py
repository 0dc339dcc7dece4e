"""hymba-1.5b — parallel attention and Mamba heads (arXiv:2411.13676).

Every layer fuses a sliding-window GQA path with a selective-SSM path;
layers {0, L/2, L-1} are global attention; 128 meta tokens prepended.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001, ssm_state=16, n_meta_tokens=128,
    window=1024,
)

SMOKE = ArchConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, ssm_state=4, n_meta_tokens=4, window=8,
    dtype="float32", kv_page_size=8,
)
