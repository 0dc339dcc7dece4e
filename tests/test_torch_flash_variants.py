"""The flash forward's variant rule, and the tensor-core backward's
rounding points emulated by ``flash_attention_bwd_tc_ref`` against the JAX
package's f32 gradient.  Split from ``test_torch_attention.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

from _torch_port import fast_reference_compiles  # noqa: F401

jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("dtype,D,Skv,kind", [
    ("bfloat16", 64, 8, "tc"), ("bfloat16", 128, 8, "tc"),
    ("bfloat16", 256, 8, "tc"), ("bfloat16", 32, 8, "simt"),
    ("bfloat16", 136, 8, "simt"), ("bfloat16", 128, 0, "simt"),
    ("float32", 128, 8, "simt"), ("float32", 64, 8, "simt"),
])
def test_flash_variant_rule(dtype, D, Skv, kind):
    """The wrapper's explicit rule: bf16 with D in (64, 128, 256) and at
    least one key runs the tensor-core kernel, everything else the SIMT
    one (decided from dtype and shape alone, never from a failure)."""
    from repro_torch.kernels.flash_attention import variant

    dt = getattr(torch, dtype)
    q = torch.empty((1, 2, 4, D), dtype=dt)
    k = torch.empty((1, 1, Skv, D), dtype=dt)
    assert variant(q, k) == kind


# The tensor-core backward's rounding points (P and dS rounded to bf16
# before dV, dK and dQ), emulated by the plain flash_attention_bwd_tc_ref,
# against jax's f32 gradient of the reference's flash_attention_xla on
# bf16-rounded inputs.  Limit: chip_smoke's BWD_TC_ROUNDING without its
# output rounding (the emulation returns f32 here): 2^-7 of the root-sum-
# square of each element's terms (the rounding's random walk; the worst
# case up to 16 terms) plus 1e-4 of the largest gradient (f32 order).  One
# shape for every case, so the cases share one reference compile.
_TC_REF_SHAPE = dict(B=1, Hq=4, Hkv=2, S=80, D=64, window=24)


@jax.jit
def _xla_flash_vjp(q, k, v, g):
    out, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_xla(
        q, k, v, causal=True, window=_TC_REF_SHAPE["window"], block_q=16,
        block_kv=16), q, k, v)
    return vjp(g)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flash_bwd_tc_rounding_emulation_matches_jax(seed):
    B, Hq, Hkv, S, D, window = (_TC_REF_SHAPE[n] for n in
                                ("B", "Hq", "Hkv", "S", "D", "window"))
    rng = np.random.default_rng(20 + seed)
    q, k, v, g = (np.array(jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
                           .astype(jnp.float32))
                  for s in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                            (B, Hq, S, D)))
    want = _xla_flash_vjp(q, k, v, g)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    kw = dict(causal=True, window=window)
    out, lse = tref.flash_attention_lse_ref(tq, tk, tv, **kw)
    got = tref.flash_attention_bwd_tc_ref(tq, tk, tv, out, lse, tg, **kw)
    plain = tref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, **kw)
    rss = tref.flash_attention_bwd_rss_ref(tq, tk, tv, out, lse, tg, **kw)
    for a, p, r, w in zip(got, plain, rss, want):
        w = torch.from_numpy(np.array(w)).double()
        assert a.dtype == torch.float32 and a.shape == w.shape
        lim = 2.0 ** -7 * r.double() + 1e-4 * float(w.abs().max())
        assert bool(((a.double() - w).abs() <= lim).all())
        assert not torch.equal(a, p)        # the rounding points are there
