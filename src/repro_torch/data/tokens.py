"""Token store: memmap-backed corpus + deterministic synthetic generator.

The port's own copy of ``repro.data.tokens`` (numpy only): ``synth_corpus``
writes the same bytes for the same arguments, ``TokenStore`` reads the same
tokens.  The synthetic corpus is a Zipf-ish Markov token stream — enough
structure that a ~100M-param model visibly learns (loss drops) in a few
hundred steps.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

__all__ = ["synth_corpus", "TokenStore"]


def synth_corpus(path, *, n_tokens: int, vocab: int, seed: int = 0,
                 order: int = 1) -> Path:
    """Write a deterministic synthetic token stream to ``path`` (memmap)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    # sparse bigram transition structure: each context prefers ~8 tokens
    n_ctx = min(vocab * 4, 65536)
    prefer = rng.integers(0, vocab, size=(n_ctx, 8), dtype=np.int32)
    out = np.empty((n_tokens,), np.int32)
    state = 0
    # vectorised blocks: choose preferred token w.p. 0.9, uniform otherwise
    block = 1 << 16
    pos = 0
    while pos < n_tokens:
        n = min(block, n_tokens - pos)
        u = rng.random(n)
        pick = rng.integers(0, 8, size=n)
        rand_tok = rng.integers(0, vocab, size=n, dtype=np.int32)
        for i in range(n):                      # cheap chain at build time
            t = prefer[state, pick[i]] if u[i] < 0.9 else rand_tok[i]
            out[pos + i] = t
            if order <= 1:
                state = int(t) % n_ctx          # pure bigram: learnable
            else:
                state = (state * 31 + int(t)) % n_ctx
        pos += n
    mm = np.memmap(path, dtype=np.int32, mode="w+", shape=(n_tokens,))
    mm[:] = out
    mm.flush()
    return path


@dataclasses.dataclass
class TokenStore:
    """Memmap token stream with (step, rank)-addressable slicing."""

    path: Path
    n_tokens: int

    @staticmethod
    def open(path) -> "TokenStore":
        path = Path(path)
        mm = np.memmap(path, dtype=np.int32, mode="r")
        return TokenStore(path=path, n_tokens=mm.shape[0])

    def read(self, offset: int, n: int) -> np.ndarray:
        mm = np.memmap(self.path, dtype=np.int32, mode="r")
        idx = (offset + np.arange(n)) % self.n_tokens
        return np.asarray(mm[idx])
