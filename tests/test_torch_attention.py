"""The port's attention kernels' plain versions against the JAX package:
``paged_attention_ref`` and ``flash_attention_ref`` held against the Pallas
kernels in interpret mode (as ``tests/test_kernels.py`` runs them, with its
small block size of 32) and against ``repro.kernels.ref``.  On the CPU the
port's ops run these plain versions; the CUDA kernels are held against them
on the card by ``chip_smoke.py`` and by the ``cuda``-marked test below.

Tolerance: ``tests/test_kernels.py``'s ``TOL`` (3e-5 in f32, 3e-2 in bf16):
the two packages sum in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops

from _torch_port import fast_reference_compiles  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x, JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _paged_inputs(B, Hq, Hkv, D, P, page, NP, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((B, P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((B, P, page, Hkv, D)).astype(np.float32)
    pt = np.stack([rng.permutation(P)[:NP] for _ in range(B)]).astype(
        np.int32)
    pt[0, NP - 1] = -1                                  # a hole
    pt[-1, 0] = -1                                      # and one at page 0
    sl = rng.integers(1, NP * page, B).astype(np.int32)
    return q, kp, vp, pt, sl


# tests/test_kernels.py's paged sweep: holes, GQA and a pool larger than
# the table in f32; no grouping and a wider head in bf16
@pytest.mark.parametrize("B,Hq,Hkv,D,P,page,NP,dtype", [
    (2, 4, 2, 32, 8, 8, 6, "float32"),
    (3, 5, 5, 64, 6, 8, 5, "bfloat16"),
])
def test_paged_attention_matches_jax(B, Hq, Hkv, D, P, page, NP, dtype):
    q, kp, vp, pt, sl = _paged_inputs(B, Hq, Hkv, D, P, page, NP)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, kp, vp))
    out = tops.paged_attention(tq, tk, tv, torch.from_numpy(pt),
                               torch.from_numpy(sl))
    assert out.dtype == tq.dtype and out.shape == (B, Hq, D)
    want_ref = jref.paged_attention_ref(jq, jk, jv, jnp.asarray(pt),
                                        jnp.asarray(sl))
    want_pal = jops.paged_attention(jq, jk, jv, jnp.asarray(pt),
                                    jnp.asarray(sl), impl="pallas",
                                    interpret=True)
    for want in (want_ref, want_pal):
        np.testing.assert_allclose(_np(out), _np(want), **TOL[dtype])


def test_paged_attention_row_without_live_keys_is_zero():
    """seq_lens 0, or every live page a hole: the row is 0, not NaN."""
    q, kp, vp, pt, sl = _paged_inputs(2, 4, 2, 16, 4, 8, 3)
    sl[0] = 0
    pt[1, :] = -1
    out = tops.paged_attention(*(torch.from_numpy(x)
                                 for x in (q, kp, vp, pt, sl)))
    assert torch.equal(out, torch.zeros_like(out))


# tests/test_kernels.py's flash sweep: GQA with a window and ragged
# non-causal in both dtypes, MQA in f32
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,window,dtype", [
    (2, 4, 2, 96, 96, 64, True, 16, "float32"),
    (2, 4, 2, 96, 96, 64, True, 16, "bfloat16"),
    (1, 8, 1, 64, 64, 32, True, None, "float32"),     # MQA
    (2, 3, 3, 33, 65, 16, False, None, "float32"),    # ragged, no GQA
    (2, 3, 3, 33, 65, 16, False, None, "bfloat16"),
])
def test_flash_attention_matches_jax(B, Hq, Hkv, Sq, Skv, D, causal, window,
                                     dtype):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == tq.dtype and out.shape == (B, Hq, Sq, D)
    want_ref = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                        window=window)
    want_pal = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    impl="pallas", interpret=True,
                                    block_q=32, block_kv=32)
    for want in (want_ref, want_pal):
        np.testing.assert_allclose(_np(out), _np(want), **TOL[dtype])


def test_flash_attention_huge_window_is_global():
    """A window as large as the reference's BIG_WINDOW (2^30) is global
    attention, with no overflow in ``q_pos - window``."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 40, 16)).astype(
        np.float32)) for _ in range(3))
    a = tops.flash_attention(q, k, v, causal=True, window=1 << 30)
    b = tops.flash_attention(q, k, v, causal=True, window=None)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_launch_counts_rise_and_attention_matches_plain():
    """On the card: each of the five kernels' launch count rises by one when
    its op runs on CUDA tensors, and the attention kernels' outputs are
    within TOL of their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    from repro_torch.kernels import (cache_probe, flash_attention,
                                     gather_blocks, paged_attention,
                                     probe_allocate, ref)

    dev = torch.device("cuda")
    tags = torch.full((4, 2), -1, dtype=torch.int32, device=dev)
    zeros = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    keys = torch.arange(8, dtype=torch.int32, device=dev)
    bam_ops = [
        (cache_probe, lambda: tops.cache_probe(tags, keys)),
        (probe_allocate, lambda: tops.probe_allocate(
            tags, zeros, zeros, zeros.bool(), zeros.bool(),
            torch.zeros((4,), dtype=torch.int32, device=dev), keys)),
        (gather_blocks, lambda: tops.gather_blocks(
            torch.ones((4, 8), device=dev), keys % 4)),
    ]
    for mod, run in bam_ops:
        n0 = mod.launches.n
        run()
        assert mod.launches.n == n0 + 1, mod.launches

    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        tol = TOL[dtype]
        q, kp, vp, pt, sl = (torch.from_numpy(x).cuda()
                             for x in _paged_inputs(2, 4, 2, 32, 8, 8, 6))
        q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
        n0 = paged_attention.launches.n
        out = paged_attention.paged_attention_cuda(q, kp, vp, pt, sl)
        assert paged_attention.launches.n == n0 + 1
        torch.testing.assert_close(
            out.float(), ref.paged_attention_ref(q, kp, vp, pt, sl).float(),
            **tol)
        x = torch.randn(3, 2, 4, 70, 32, device="cuda").to(dt)
        n0 = flash_attention.launches.n
        out = flash_attention.flash_attention_cuda(x[0], x[1], x[2],
                                                   causal=True, window=16)
        assert flash_attention.launches.n == n0 + 1
        torch.testing.assert_close(
            out.float(), ref.flash_attention_ref(
                x[0], x[1], x[2], causal=True, window=16).float(), **tol)
