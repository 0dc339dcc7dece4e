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
from repro_torch.kernels import ref as tref

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


# The CUDA kernel's split-KV arithmetic (chunks of logical positions, a
# partial (m, l, acc) per chunk, a combine in logical order), emulated in
# plain PyTorch, against the JAX package.  Small chunks make the edge cases
# appear at a small size.
@pytest.mark.parametrize("chunk,page,lens,holes", [
    # chunks wholly inside a hole page; sequence 0 ends mid-chunk
    (4, 8, (13, 30), ((0, 1), (1, 0))),
    # a sequence with no live key (every chunk empty); a chunk half hole
    (16, 8, (0, 21), ((1, 1),)),
    # chunks that straddle page edges; an empty chunk past a hole
    (6, 8, (47, 5), ((0, 2), (1, 0))),
])
def test_paged_split_combine_matches_jax(chunk, page, lens, holes):
    B, Hq, Hkv, D, P, NP = 2, 4, 2, 16, 8, 6
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((B, P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((B, P, page, Hkv, D)).astype(np.float32)
    pt = np.stack([rng.permutation(P)[:NP] for _ in range(B)]).astype(
        np.int32)
    for b, i in holes:
        pt[b, i] = -1
    sl = np.asarray(lens, np.int32)
    out = tref.paged_attention_chunked_ref(
        *(torch.from_numpy(x) for x in (q, kp, vp, pt, sl)), chunk=chunk)
    assert out.dtype == torch.float32 and out.shape == (B, Hq, D)
    j = [jnp.asarray(x) for x in (q, kp, vp, pt, sl)]
    want_ref = jref.paged_attention_ref(*j)
    want_pal = jops.paged_attention(*j, impl="pallas", interpret=True)
    for want in (want_ref, want_pal):
        np.testing.assert_allclose(_np(out), _np(want), **TOL["float32"])


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


@pytest.mark.cuda
def test_cuda_launch_counts_rise_and_attention_matches_plain():
    """On the card: each of the five kernels' launch count rises by one when
    its op runs on CUDA tensors, and the attention kernels' outputs are
    within TOL of their plain versions.  bf16 flash at D 64 and 128 runs the
    tensor-core kernel, f32 and bf16 at D 32 the SIMT one; the paged
    kernel's output does not change, bit for bit, when the physical pages
    are permuted along with the page table."""
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
        # the same pages at other physical slots give the same bits
        perm = torch.stack([torch.randperm(kp.shape[1], device=dev)
                            for _ in range(kp.shape[0])])
        bidx = torch.arange(kp.shape[0], device=dev)[:, None]
        kp2, vp2 = torch.empty_like(kp), torch.empty_like(vp)
        kp2[bidx, perm] = kp
        vp2[bidx, perm] = vp
        pt2 = torch.where(pt >= 0, torch.gather(perm, 1, pt.clamp(min=0).long())
                          .to(torch.int32), pt)
        assert torch.equal(
            paged_attention.paged_attention_cuda(q, kp2, vp2, pt2, sl), out)
        for D, kind in ((64, "tc" if dtype == "bfloat16" else "simt"),
                        (128, "tc" if dtype == "bfloat16" else "simt"),
                        (32, "simt")):
            x = torch.randn(3, 2, 4, 70, D, device="cuda").to(dt)
            n0 = flash_attention.launches.n
            v0 = flash_attention.variant_launches[kind].n
            out = flash_attention.flash_attention_cuda(x[0], x[1], x[2],
                                                       causal=True, window=16)
            assert flash_attention.launches.n == n0 + 1
            assert flash_attention.variant_launches[kind].n == v0 + 1, kind
            torch.testing.assert_close(
                out.float(), ref.flash_attention_ref(
                    x[0], x[1], x[2], causal=True, window=16).float(), **tol)


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


def test_flash_forward_without_grad_saves_nothing():
    """With nothing requiring grad the op is the plain forward call (no
    autograd node); with grad on an input it goes through the autograd
    function, whose CPU forward is the same plain version."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 9, 8)).astype(
        np.float32)) for _ in range(3))
    plain = tops.flash_attention(q, k, v, causal=True, window=4)
    assert plain.grad_fn is None
    with_grad = tops.flash_attention(q.requires_grad_(True), k, v,
                                     causal=True, window=4)
    assert type(with_grad.grad_fn).__name__ == "_FlashAttentionBackward"
    assert torch.equal(with_grad.detach(), plain)


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
