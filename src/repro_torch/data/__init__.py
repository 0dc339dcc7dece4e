"""Training data: the synthetic token corpus and the deterministic loader
(own copies of ``repro.data``, numpy only)."""
from repro_torch.data.pipeline import DataConfig, Loader, make_loader
from repro_torch.data.tokens import TokenStore, synth_corpus

__all__ = ["DataConfig", "Loader", "make_loader", "TokenStore",
           "synth_corpus"]
