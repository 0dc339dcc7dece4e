"""The flash backward's plain version against the JAX package
(``repro.kernels.ref.flash_attention_xla``'s ``custom_vjp`` backward, and
autograd of the dense plain forward), the backward's variant rule, and on
the card the backward kernel against its plain version (``cuda``-marked).
Split from ``test_torch_attention.py``, whose ``TOL`` it uses.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_port import fast_reference_compiles  # noqa: F401
from test_torch_attention import TOL

jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("dtype,D,Skv,kind", [
    ("bfloat16", 64, 8, "tc"), ("bfloat16", 128, 8, "tc"),
    ("bfloat16", 256, 8, "tc"), ("bfloat16", 16, 8, "simt"),
    ("bfloat16", 96, 8, "simt"), ("bfloat16", 256, 0, "simt"),
    ("float32", 256, 8, "simt"), ("float32", 64, 8, "simt"),
])
def test_flash_bwd_variant_rule(dtype, D, Skv, kind):
    """The backward's variant follows the forward's rule: bf16 with D in
    (64, 128, 256) and at least one key runs the tensor-core backward,
    everything else (every f32 call, so the f32 train step) the SIMT one."""
    from repro_torch.kernels.flash_attention import bwd_variant

    dt = getattr(torch, dtype)
    q = torch.empty((1, 4, 4, D), dtype=dt)
    k = torch.empty((1, 2, Skv, D), dtype=dt)
    assert bwd_variant(q, k) == kind


# The flash backward's plain version: against jax's gradient of the
# reference's blockwise flash_attention_xla (its custom_vjp backward, at
# blocks of 16 so the queries and keys are padded) in f32, and against
# autograd of the port's dense flash_attention_ref; the port's autograd
# function (CPU backward = the plain version) too.  Causal with GQA G 4, a
# window with G 5, non-causal Sq != Skv with G 1, and causal with a window
# that leaves the rows from 14 on without a live key (G 2).
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,window", [
    (2, 4, 1, 40, 40, 16, True, None),
    (1, 5, 1, 33, 33, 8, True, 7),
    (2, 3, 3, 20, 37, 8, False, None),
    (1, 4, 2, 40, 10, 8, True, 5),
])
def test_flash_backward_matches_jax(B, Hq, Hkv, Sq, Skv, D, causal, window):
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    g = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)

    @jax.jit
    def ref_vjp(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_xla(
            q, k, v, causal=causal, window=window, block_q=16, block_kv=16),
            q, k, v)
        return out, vjp(g)

    want_out, want = ref_vjp(q, k, v, g)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = tref.flash_attention_lse_ref(tq, tk, tv, causal=causal,
                                            window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               **TOL["float32"])
    got = tref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tg,
                                       causal=causal, window=window)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    dense = torch.autograd.grad(tref.flash_attention_ref(
        *leaves, causal=causal, window=window), leaves, tg)
    via_op = torch.autograd.grad(tops.flash_attention(
        *leaves, causal=causal, window=window), leaves, tg)
    for a, b, c, w in zip(got, dense, via_op, want):
        assert a.dtype == torch.float32 and a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                   **TOL["float32"])
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL["float32"])
        assert torch.equal(a, c)
    if window == 5:                   # rows 14.. have no key: no gradient
        assert not bool(got[0][:, :, 14:].any())
        assert bool((lse[:, :, 14:] <= -1e29).all())


@pytest.mark.cuda
def test_cuda_flash_backward_launches_and_matches_plain():
    """On the card: a grad through ``ops.flash_attention`` launches the
    forward with its lse once and the backward kernel once, on its f32
    ``"simt"`` variant, and the gradients equal the plain backward's within
    1e-4 of their largest magnitude (f32), bit-identical across two runs;
    in bf16 at D 64 the backward runs its ``"tc"`` variant, within
    ``BWD_TC_ROUNDING`` of the plain version in f32 (as chip_smoke.py
    states it: 2^-8 of the element, 2^-7 of its terms' root-sum-square and
    1e-4 of the largest gradient), also bit-identical across two runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(8)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).cuda() for s in ((2, 4, 40, 64), (2, 1, 40, 64),
                                      (2, 1, 40, 64), (2, 4, 40, 64)))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    f0, b0 = fa.launches.n, fa.bwd_launches.n
    s0 = fa.bwd_variant_launches["simt"].n
    out = tops.flash_attention(*leaves, causal=True, window=16)
    got = torch.autograd.grad(out, leaves, g)
    assert (fa.launches.n, fa.bwd_launches.n) == (f0 + 1, b0 + 1)
    assert fa.bwd_variant_launches["simt"].n == s0 + 1
    o, lse = tref.flash_attention_lse_ref(q, k, v, causal=True, window=16)
    want = tref.flash_attention_bwd_ref(q, k, v, o, lse, g, causal=True,
                                        window=16)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    again = torch.autograd.grad(tops.flash_attention(
        *leaves, causal=True, window=16), leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    qb, kb, vb, gb = (t.bfloat16() for t in (q, k, v, g))
    ob, lb = fa.flash_attention_cuda(qb, kb, vb, causal=True, window=16,
                                     return_lse=True)
    t0 = fa.bwd_variant_launches["tc"].n
    got = fa.flash_attention_bwd_cuda(qb, kb, vb, ob, lb, gb, causal=True,
                                      window=16)
    assert fa.bwd_variant_launches["tc"].n == t0 + 1
    f32 = [t.float() for t in (qb, kb, vb, ob)]
    want = tref.flash_attention_bwd_ref(*f32, lb, gb.float(), causal=True,
                                        window=16)
    rss = tref.flash_attention_bwd_rss_ref(*f32, lb, gb.float(), causal=True,
                                           window=16)
    for a, b, r in zip(got, want, rss):
        lim = 2.0 ** -8 * b.abs() + 2.0 ** -7 * r + 1e-4 * b.abs().max()
        assert bool(((a.float() - b).abs() <= lim).all())
    again = fa.flash_attention_bwd_cuda(qb, kb, vb, ob, lb, gb, causal=True,
                                        window=16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
