"""moonshot-v1-16b-a3b (kimi/moonlight) — 64-expert top-6 MoE.
long_500k: SKIPPED (full attention)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=163840, moe=True, n_experts=64, top_k=6,
    bam_expert_paging=True,
)

SMOKE = ArchConfig(
    name="moonshot-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=48,
    vocab=256, moe=True, n_experts=8, top_k=2, dtype="float32",
    kv_page_size=8, bam_expert_paging=True,
)
