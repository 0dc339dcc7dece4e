"""The port's three hot-path kernels against the JAX package's Pallas
kernels (interpret mode, as ``repro``'s own tests run them) and its jnp
oracles.  On the CPU the port's ops run the plain PyTorch versions; the
CUDA kernels are held against those same plain versions on the card by
``chip_smoke.py`` and by the ``cuda``-marked test below.

Tolerance: none.  Integer and bool outputs are bit-identical; gathered
values are copies, so they are exact in every dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import probe_allocate_ref

from _torch_port import fast_reference_compiles  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

PA_NAMES = ("hit", "hit_slot", "way", "ok", "evicted_key", "evicted_dirty")

# The policy variants of tests/test_probe_allocate.py.  Every case also
# passes protect_slots and an alloc_mask; the random directory holds
# foreign (owner != tenant) dirty lines, pinned lines and speculative
# lines, and the wavefront holds negative keys and duplicate keys (so
# several misses share a set).
VARIANTS = [
    dict(),
    dict(tenant=1),
    dict(way_lo=1, way_hi=3),
    dict(spec_insert=True),
    dict(protect_hits=False),
    dict(tenant=2, way_lo=0, way_hi=2, spec_insert=True),
]
# every variant on the first grid point; the second (8 ways, a ragged m)
# for the default and the combined variant only: interpret mode is slow
CASES = [((16, 4, 64), vi) for vi in range(len(VARIANTS))] \
    + [((8, 8, 33), 0), ((8, 8, 33), 5)]


def _np_hash(k):
    k = (np.asarray(k).astype(np.uint64) * 2654435761) & 0xFFFFFFFF
    return ((k ^ (k >> 16)) & 0x7FFFFFFF).astype(np.int64)


def _consistent_tags(rng, S, W, hi):
    """Tags that sit in their own hash set (so probes can hit), with about
    a quarter of the ways invalid."""
    tags = np.full((S, W), -1, np.int32)
    fill = np.zeros(S, int)
    for k in rng.permutation(hi):
        s = _np_hash(k) % S
        if fill[s] < W:
            tags[s, fill[s]] = k
            fill[s] += 1
    tags[rng.random((S, W)) < 0.25] = -1
    return tags


def _directory(rng, S, W):
    return dict(
        tags=_consistent_tags(rng, S, W, 6 * S * W),
        owner=rng.integers(0, 3, (S, W)).astype(np.int32),
        refcount=(rng.integers(0, 2, (S, W))
                  * rng.integers(1, 3, (S, W))).astype(np.int32),
        dirty=rng.integers(0, 2, (S, W)).astype(bool),
        speculative=rng.integers(0, 2, (S, W)).astype(bool),
        clock_hand=rng.integers(0, W, (S,)).astype(np.int32))


def _wavefront(rng, S, W, m, tags):
    keys = rng.integers(-1, 6 * S * W, m)
    keys[: m // 4] = rng.choice(tags.reshape(-1), m // 4)
    keys[m // 2:] = rng.choice(keys[:m // 2], m - m // 2)
    return keys.astype(np.int32)


def _pa_inputs(S, W, m, vi):
    rng = np.random.default_rng(1000 * vi + S + W + m)
    d = _directory(rng, S, W)
    keys = _wavefront(rng, S, W, m, d["tags"])
    prot = rng.integers(-1, S * W, max(m // 4, 1)).astype(np.int32)
    amask = rng.integers(0, 2, m).astype(bool)
    return d, keys, prot, amask


def _torch_pa(d, keys, prot, amask, kw, device="cpu"):
    t = {k: torch.from_numpy(v).to(device) for k, v in d.items()}
    return tops.probe_allocate(
        t["tags"], t["owner"], t["refcount"], t["dirty"], t["speculative"],
        t["clock_hand"], torch.from_numpy(keys).to(device),
        protect_slots=torch.from_numpy(prot).to(device),
        alloc_mask=torch.from_numpy(amask).to(device), **kw)


@pytest.mark.parametrize("shape,vi", CASES)
def test_probe_allocate_matches_pallas_and_ref(shape, vi):
    S, W, m = shape
    kw = VARIANTS[vi]
    d, keys, prot, amask = _pa_inputs(S, W, m, vi)
    out_t = _torch_pa(d, keys, prot, amask, kw)
    jargs = [jnp.asarray(d[k]) for k in ("tags", "owner", "refcount",
                                         "dirty", "speculative",
                                         "clock_hand")]
    jkw = dict(protect_slots=jnp.asarray(prot), alloc_mask=jnp.asarray(amask),
               **kw)
    out_p = jops.probe_allocate(*jargs, jnp.asarray(keys), impl="pallas",
                                interpret=True, **jkw)
    out_r = jops.probe_allocate(*jargs, jnp.asarray(keys), impl="ref", **jkw)
    assert bool(out_t[3].any()), "the case should grant some victims"
    assert bool(out_t[0].any()), "the case should hit some lines"
    for name, a, p, r in zip(PA_NAMES, out_t, out_p, out_r):
        np.testing.assert_array_equal(a.numpy(), np.asarray(p),
                                      err_msg=f"{name} vs pallas {kw}")
        np.testing.assert_array_equal(a.numpy(), np.asarray(r),
                                      err_msg=f"{name} vs ref {kw}")


# Wide sets (W 16 and 32, where a set's lanes fill half or all of a warp
# on the card) and a skewed wavefront (every key in 2 of 16 sets, so each
# set's misses run far past its ways and past the kernel's bucket of 8
# entries a lane).  Held against the JAX package's jnp oracle only: its
# Pallas kernel takes over a second to trace at each of these shapes.
WIDE = [((8, 16, 40), 0), ((4, 32, 48), 5)]


def _skewed_inputs(S=16, W=4, m=160, n_sets=2):
    """m keys whose hashes fall into n_sets of the S sets (the resident
    ones among them), with protect slots and an alloc mask."""
    rng = np.random.default_rng(5)
    d = _directory(rng, S, W)
    cand = np.arange(64 * S * W)
    hot = rng.choice(S, n_sets, replace=False)
    cand = cand[np.isin(_np_hash(cand) % S, hot)]
    keys = rng.permutation(cand)[:m]
    resident = d["tags"][hot].reshape(-1)
    resident = resident[resident >= 0]
    keys[:resident.size] = resident
    keys = rng.permutation(keys).astype(np.int32)
    prot = rng.integers(-1, S * W, 4).astype(np.int32)
    amask = rng.random(m) < 0.9
    return d, keys, prot, amask


def _pa_vs_jax_ref(d, keys, prot, amask, kw):
    out_t = _torch_pa(d, keys, prot, amask, kw)
    jargs = [jnp.asarray(d[k]) for k in ("tags", "owner", "refcount",
                                         "dirty", "speculative",
                                         "clock_hand")]
    out_r = jops.probe_allocate(*jargs, jnp.asarray(keys), impl="ref",
                                protect_slots=jnp.asarray(prot),
                                alloc_mask=jnp.asarray(amask), **kw)
    for name, a, r in zip(PA_NAMES, out_t, out_r):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r),
                                      err_msg=f"{name} vs ref {kw}")
    return out_t


@pytest.mark.parametrize("shape,vi", WIDE)
def test_probe_allocate_wide_sets_match_ref(shape, vi):
    S, W, m = shape
    out = _pa_vs_jax_ref(*_pa_inputs(S, W, m, vi), VARIANTS[vi])
    assert bool(out[3].any()) and bool(out[0].any())


def test_probe_allocate_skewed_buckets_match_ref():
    d, keys, prot, amask = _skewed_inputs()
    sets = _np_hash(keys) % 16
    assert len(set(sets.tolist())) == 2 and np.bincount(sets).max() > 32
    out = _pa_vs_jax_ref(d, keys, prot, amask, {})
    assert bool(out[3].any()) and bool(out[0].any())
    # a set grants at most W ways
    assert int(out[3].sum()) <= 2 * 4


def test_probe_allocate_all_hit_and_empty():
    """The no-miss branch (all lanes hit or invalid) and m = 0."""
    rng = np.random.default_rng(3)
    d = _directory(rng, 8, 4)
    d["owner"][:] = 0
    keys = np.concatenate([d["tags"][d["tags"] >= 0][:10],
                           [-1, -1]]).astype(np.int32)
    hit_t = _torch_pa(d, keys, np.full(1, -1, np.int32),
                      np.ones(keys.shape, bool), {})
    jargs = [jnp.asarray(d[k]) for k in ("tags", "owner", "refcount",
                                         "dirty", "speculative",
                                         "clock_hand")]
    r = jops.probe_allocate(*jargs, jnp.asarray(keys), impl="ref")
    for name, a, b in zip(PA_NAMES, hit_t, r):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(hit_t[0].sum()) == 10 and not bool(hit_t[3].any())
    empty = probe_allocate_ref(
        *[torch.from_numpy(d[k]) for k in ("tags", "owner", "refcount",
                                           "dirty", "speculative",
                                           "clock_hand")],
        torch.zeros((0,), dtype=torch.int32), torch.zeros((0,), dtype=bool))
    assert all(x.shape == (0,) for x in empty)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On the card: each CUDA kernel bit-identical to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    from repro_torch.kernels import ref
    from repro_torch.kernels.cache_probe import cache_probe_cuda
    from repro_torch.kernels.gather_blocks import gather_blocks_cuda
    from repro_torch.kernels.probe_allocate import probe_allocate_cuda

    for (d, keys, prot, amask), kw in [
            (_pa_inputs(S, W, m, vi), VARIANTS[vi])
            for (S, W, m), vi in CASES + WIDE] + [(_skewed_inputs(), {})]:
        t = {k: torch.from_numpy(v).cuda() for k, v in d.items()}
        args = (t["tags"], t["owner"], t["refcount"], t["dirty"],
                t["speculative"], t["clock_hand"],
                torch.from_numpy(keys).cuda())
        valid = args[-1] >= 0
        extra = (torch.from_numpy(amask).cuda(),
                 torch.from_numpy(prot).cuda())
        a = probe_allocate_cuda(*args, valid, *extra, **kw)
        b = ref.probe_allocate_ref(*args, valid, *extra, **kw)
        for name, x, y in zip(PA_NAMES, a, b):
            assert torch.equal(x, y), (name, d["tags"].shape, kw)
        hit, slot = cache_probe_cuda(t["tags"], args[-1], owner=t["owner"],
                                     tenant=kw.get("tenant", 0))
        rh, rs = ref.cache_probe_ref(t["tags"], args[-1],
                                     owner=t["owner"],
                                     tenant=kw.get("tenant", 0))
        assert torch.equal(hit, rh) and torch.equal(slot, rs)
    data = torch.randn(64, 48, device="cuda")
    slots = torch.randint(-3, 64, (500,), device="cuda", dtype=torch.int32)
    off = torch.randint(0, 48, (500,), device="cuda", dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        x = (data * 100).to(dt)
        assert torch.equal(gather_blocks_cuda(x, slots),
                           ref.gather_blocks_ref(x, slots))
        assert torch.equal(gather_blocks_cuda(x, slots, off=off),
                           ref.gather_blocks_ref(x, slots, off=off))
