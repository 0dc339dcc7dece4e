"""whisper-large-v3 — enc-dec audio transformer (arXiv:2212.04356).

Conv/mel frontend is a stub: the caller passes precomputed frame
embeddings (B, 1500, d_model) as ``batch["enc_frames"]`` for the encoder.
Decoder = causal self-attn + cross-attn.  long_500k: SKIPPED (full
attention, enc-dec).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab=51866, enc_dec=True, n_enc_layers=32, enc_seq=1500,
    norm="layer", act="gelu", gated_mlp=False, pos_emb="learned",
)

SMOKE = ArchConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, enc_dec=True, n_enc_layers=2, enc_seq=16,
    norm="layer", act="gelu", gated_mlp=False, pos_emb="learned",
    dtype="float32", kv_page_size=8,
)
