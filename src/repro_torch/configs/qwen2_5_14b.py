"""qwen2.5-14b — dense GQA with QKV bias. long_500k: SKIPPED (full attn)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
    vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="qwen-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, qkv_bias=True, dtype="float32", kv_page_size=8,
)
