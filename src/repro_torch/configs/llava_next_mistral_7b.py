"""llava-next-mistral-7b — Mistral-7B backbone + anyres vision tiling (stub).

The modality frontend is a stub: the caller passes precomputed patch
embeddings (B, n_patches, d_model) as ``batch["patch_embeds"]``, which
``forward`` prepends to the text embeddings.  long_500k: SKIPPED (pure
full attention).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, rope_theta=1_000_000.0, n_patches=2880,
)

SMOKE = ArchConfig(
    name="llava-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, n_patches=8, dtype="float32", kv_page_size=8,
)
