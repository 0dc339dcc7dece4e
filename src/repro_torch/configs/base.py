"""Architecture and shape-cell configs.

Port of ``repro.configs.base``: ``ArchConfig``, ``SHAPES``, ``get_config``
and ``smoke_config``, with ``compute_dtype`` as a ``torch.dtype``.  The
registry holds every config of the reference.  The dry-run's
``input_specs`` has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    norm: str = "rms"           # rms | layer
    act: str = "silu"
    gated_mlp: bool = True
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"       # rope | learned | none
    qk_norm: bool = False
    tie_embeddings: bool = False
    # local:global attention interleave: (n_local, n_global) repeating
    window: Optional[int] = None
    local_ratio: Tuple[int, int] = (0, 1)
    logit_softcap: Optional[float] = None
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # enc-dec (audio)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500
    # ssm / hybrid
    ssm_state: int = 0
    n_meta_tokens: int = 0
    slstm_every: int = 0
    proj_factor: float = 2.0
    # vlm
    n_patches: int = 0
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # BaM integration
    bam_kv: bool = True
    kv_page_size: int = 256
    bam_expert_paging: bool = False
    bam_embedding: bool = False
    remat: str = "full"
    use_pallas: str = "auto"
    flash_decode_shards: bool = False
    attn_f32: bool = True
    moe_combine: str = "gather"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def group(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_sub_quadratic(self) -> bool:
        if self.family in ("ssm", "hybrid"):
            return True
        return self.window is not None and self.local_ratio[0] > 0

    def supports_cell(self, cell: ShapeCell) -> bool:
        if cell.name == "long_500k":
            return self.is_sub_quadratic
        return True

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def layer_windows(self, seq_len: int):
        """Per-layer window sizes; >= seq_len means global attention."""
        big = max(seq_len, 1 << 30 - 1)
        nl, ng = self.local_ratio
        period = max(nl + ng, 1)
        out = []
        for i in range(self.n_layers):
            if self.window is not None and nl > 0 and (i % period) < nl:
                out.append(self.window)
            else:
                out.append(big)
        return out


# -------------------------------------------------------------- registry ---
PORTED = [
    "qwen2_5_14b", "minitron_4b", "gemma3_12b", "gemma3_1b", "olmoe_1b_7b",
    "moonshot_v1_16b_a3b", "llava_next_mistral_7b", "whisper_large_v3",
    "xlstm_1_3b", "hymba_1_5b",
]

_ALIASES = {a.replace("_", "-"): a for a in PORTED}
_ALIASES.update({
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "gemma3-12b": "gemma3_12b", "gemma3-1b": "gemma3_1b",
    "qwen2.5-14b": "qwen2_5_14b", "minitron-4b": "minitron_4b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "whisper-large-v3": "whisper_large_v3", "xlstm-1.3b": "xlstm_1_3b",
    "hymba-1.5b": "hymba_1_5b",
})


def _module(name: str):
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in PORTED:
        raise KeyError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).SMOKE
