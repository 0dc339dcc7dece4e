"""Roofline terms of one device's step, for an NVIDIA H100.

  compute term    = FLOPs / peak_FLOP/s
  memory term     = bytes / HBM_bw
  collective term = collective_bytes / link_bw

Port of ``repro.launch.roofline``.  FLOPs, bytes and collective bytes come
from the dispatch walk (:mod:`repro_torch.launch.op_analysis`) of one
rank's step and are **per device** already, so each term divides by one
card's peak.  The peaks are fields, so one cell takes the f32 peak and
another the bf16 tensor-core peak; ``to_dict`` has the reference's keys.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# NVIDIA H100 80GB HBM3 (SXM5, 700 W), NVIDIA H100 Tensor Core GPU data
# sheet: dense bf16 tensor-core FLOP/s, f32 FLOP/s without tensor cores,
# HBM3 bytes/s, NVLink 4 bytes/s in one direction (900 GB/s both ways),
# device memory bytes.
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_F32 = 67e12
HBM_BW = 3.35e12
LINK_BW = 450e9
HBM_BYTES = 80e9

__all__ = ["HBM_BW", "HBM_BYTES", "LINK_BW", "PEAK_FLOPS_BF16",
           "PEAK_FLOPS_F32", "Roofline", "model_flops_for_cell",
           "peak_flops_for"]


def peak_flops_for(dtype) -> float:
    """The card's peak for a step computing in ``dtype`` (a name or a
    ``torch.dtype``): the f32 peak for float32, else bf16's."""
    return PEAK_FLOPS_F32 if "float32" in str(dtype) else PEAK_FLOPS_BF16


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    mem_bytes_per_device: float
    coll_bytes_per_device: float
    model_flops: float = 0.0       # 6*N*D (or 6*N_active*D) global
    chips: int = 1
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.mem_bytes_per_device / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_device / self.link_bw

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Perfect-overlap model: the dominant term is the step time."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): recompute and redundancy
        waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total > 0 else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the modelled step
        time: (MODEL_FLOPS / step_s) / (chips x peak)."""
        if self.step_s <= 0:
            return 0.0
        ach = self.model_flops / self.step_s
        return ach / (self.chips * self.peak_flops)

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops_per_device,
            "mem_bytes_per_device": self.mem_bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound": self.bound,
            "step_s": self.step_s,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for_cell(cfg, cell) -> float:
    """MODEL_FLOPS per step: 6*N_active*tokens (train), 2*N_active*tokens
    (prefill), 2*N_active*batch (decode) + attention read terms."""
    from repro_torch.models.model import active_params
    n = active_params(cfg)
    tokens = cell.global_batch * (cell.seq_len
                                  if cell.kind in ("train", "prefill") else 1)
    mult = 6.0 if cell.kind == "train" else 2.0
    base = mult * n * tokens
    # attention score+value FLOPs
    attn = 0.0
    if cell.kind in ("train", "prefill"):
        for w in cfg.layer_windows(cell.seq_len):
            s_eff = min(w, cell.seq_len)
            # average causal context ~ s_eff/2 (window: ~w)
            ctx = s_eff / 2 if w >= cell.seq_len else s_eff
            attn += 2 * 2 * ctx * cfg.n_heads * cfg.hd * tokens
        if cell.kind == "train":
            attn *= 3  # fwd + 2x bwd
    else:
        for w in cfg.layer_windows(cell.seq_len):
            ctx = min(w, cell.seq_len)
            attn += 2 * 2 * ctx * cfg.n_heads * cfg.hd * cell.global_batch
    if cfg.family == "ssm":
        attn = 0.0  # recurrent state term is part of N_active math
    return base + attn
