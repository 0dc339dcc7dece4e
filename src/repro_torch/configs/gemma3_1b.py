"""gemma3-1b — small gemma3: 5:1 local:global, kv=1 (MQA), 262k vocab."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144, qk_norm=True, tie_embeddings=True,
    window=512, local_ratio=(5, 1), rope_theta=1_000_000.0, act="gelu",
)

SMOKE = ArchConfig(
    name="gemma3-1b-smoke", family="dense",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=1, head_dim=12,
    d_ff=96, vocab=128, qk_norm=True, tie_embeddings=True,
    window=8, local_ratio=(2, 1), act="gelu", dtype="float32",
    kv_page_size=8,
)
