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


@pytest.mark.parametrize("with_owner", [False, True])
def test_cache_probe_matches_pallas_and_ref(with_owner):
    rng = np.random.default_rng(11 + with_owner)
    S, W, m = 16, 4, 300
    tags = _consistent_tags(rng, S, W, 4 * S * W)
    owner = rng.integers(0, 2, (S, W)).astype(np.int32)
    keys = np.concatenate([tags.reshape(-1), rng.integers(-3, 4 * S * W,
                                                          m - S * W)])
    keys = rng.permutation(keys).astype(np.int32)
    kw = dict(tenant=1) if with_owner else {}
    jo = dict(owner=jnp.asarray(owner)) if with_owner else {}
    to = dict(owner=torch.from_numpy(owner)) if with_owner else {}
    hit_t, slot_t = tops.cache_probe(torch.from_numpy(tags),
                                     torch.from_numpy(keys), **to, **kw)
    for impl in ("pallas", "ref"):
        extra = dict(interpret=True, block_m=128) if impl == "pallas" else {}
        hit_j, slot_j = jops.cache_probe(jnp.asarray(tags), jnp.asarray(keys),
                                         impl=impl, **jo, **kw, **extra)
        np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_j))
        np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    assert bool(hit_t.any()) and not bool(hit_t.all())


def _to_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_gather_blocks_matches_pallas_and_ref(dtype):
    rng = np.random.default_rng(7)
    n_lines, line, n = 12, 16, 40
    base = rng.standard_normal((n_lines, line)) * 100
    slots = rng.integers(-2, n_lines, n).astype(np.int32)
    off = rng.integers(0, line, n).astype(np.int32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "int32": jnp.int32}[dtype]
    jdata = jnp.asarray(base).astype(jdt)
    tdata = torch.from_numpy(np.array(jdata.astype(jnp.float32))).to(
        getattr(torch, dtype))
    lines_t = tops.gather_blocks(tdata, torch.from_numpy(slots))
    elems_t = tops.gather_blocks(tdata, torch.from_numpy(slots),
                                 off=torch.from_numpy(off))
    for impl, extra in (("pallas", dict(interpret=True)), ("ref", {})):
        lines_j = jops.gather_blocks(jdata, jnp.asarray(slots), impl=impl,
                                     **extra)
        elems_j = jops.gather_blocks(jdata, jnp.asarray(slots),
                                     off=jnp.asarray(off), impl=impl, **extra)
        np.testing.assert_array_equal(
            _to_np(lines_t), np.asarray(lines_j.astype(jnp.float32)))
        np.testing.assert_array_equal(
            _to_np(elems_t), np.asarray(elems_j.astype(jnp.float32)))


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On the card: each CUDA kernel bit-identical to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    from repro_torch.kernels import ref
    from repro_torch.kernels.cache_probe import cache_probe_cuda
    from repro_torch.kernels.gather_blocks import gather_blocks_cuda
    from repro_torch.kernels.probe_allocate import probe_allocate_cuda

    for (S, W, m), vi in CASES:
        kw = VARIANTS[vi]
        d, keys, prot, amask = _pa_inputs(S, W, m, vi)
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
            assert torch.equal(x, y), (name, S, W, m, kw)
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
