"""olmoe-1b-7b — 64-expert top-8 MoE (arXiv:2409.02060).

``bam_expert_paging`` is carried as the reference's config carries it; no
code of either package reads it, so every expert's weights stay resident.
long_500k: SKIPPED (full attn).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50304, moe=True, n_experts=64, top_k=8, qk_norm=True,
    bam_expert_paging=True,
)

SMOKE = ArchConfig(
    name="olmoe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    vocab=256, moe=True, n_experts=8, top_k=2, qk_norm=True,
    dtype="float32", kv_page_size=8, bam_expert_paging=True,
)
