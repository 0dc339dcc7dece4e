"""gemma3-12b — 5:1 local:global sliding-window interleave, 262k vocab.

Local layers use a 1024-token window; every 6th layer is global.  The
global layers' decode KV is BaM-paged (page table + striped pool), which is
what makes long_500k runnable (locals are O(W), globals O(S) per token).
In ``repro_torch`` the sliding-window (ring) layers are not ported yet: the
model runs this config only as all-global (``window=None,
local_ratio=(0, 1)``), and raises otherwise.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144, qk_norm=True, tie_embeddings=True,
    window=1024, local_ratio=(5, 1), rope_theta=1_000_000.0, act="gelu",
)

SMOKE = ArchConfig(
    name="gemma3-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, qk_norm=True, tie_embeddings=True,
    window=8, local_ratio=(2, 1), act="gelu", dtype="float32",
    kv_page_size=8,
)
