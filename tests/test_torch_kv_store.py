"""``repro_torch``'s ``BamKVStore`` against ``repro.core``'s: the
``test_kv_store*`` cases of ``tests/test_bam_array.py`` and a store over a
runtime tenant (:class:`RtBoth`, compared after every op).  Split from
``test_torch_runtime.py``, whose runtime builder it uses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BamKVStore as JKV
from repro_torch.core.bam_array import BamKVStore as TKV

from _torch_port import fast_reference_compiles  # noqa: F401
from test_torch_runtime import BE, _both

jax.config.update("jax_platform_name", "cpu")


def test_kv_store_rides_a_runtime_tenant():
    """A ``BamKVStore`` over a runtime tenant's array, looked up through a
    tenant view and absorbed back, on both packages: found mask, values
    and state."""
    keys = np.arange(64, dtype=np.int32)
    values = np.arange(64 * BE, dtype=np.float32).reshape(64, BE)
    table, store_vals, cap = JKV.build_table(keys, values, capacity=128)
    t_table, t_vals, t_cap = TKV.build_table(keys, values, capacity=128)
    np.testing.assert_array_equal(t_table, table)
    np.testing.assert_array_equal(t_vals, store_vals)
    b = _both([("kv", store_vals, {}), ("other", np.zeros(64, np.float32),
                                        {})], key="kv", num_sets=8, ways=4)
    jkv = JKV(array=b.jrt.array("kv"), capacity=cap, value_elems=BE)
    tkv = TKV(array=b.trt.array("kv"), capacity=t_cap, value_elems=BE)
    jrt = b.jrt

    def jround(rst, keys):
        vals, found, st = jkv.lookup(jrt.tenant_view(rst, "kv"),
                                     jnp.asarray(table), keys)
        return vals, found, jrt.absorb(rst, "kv", st)

    jround = b._op("kv_round", lambda: jround)
    tt = torch.from_numpy(t_table)
    for q in ([0, 17, 63, 99], [5, 17, -1, 63]):
        q = np.asarray(q, np.int32)
        jv, jf, b.jrst = jround(b.jrst, jnp.asarray(q))
        st = b.trt.tenant_view(b.trst, "kv")
        tv, tf, st = tkv.lookup(st, tt, torch.from_numpy(q))
        b.trst = b.trt.absorb(b.trst, "kv", st)
        b.check(f"lookup {q}")
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        hit = (q >= 0) & (q < 64)
        np.testing.assert_array_equal(tf.numpy(), hit)
        np.testing.assert_array_equal(tv.numpy()[hit], values[q[hit]])


KV_CASES = {
    "basic": ([3, 17, 123, 99], [17, 99, 5], dict()),
    # keys whose wrapped product lands >= 2^31 (key 1: 2654435761)
    "hash_wrap": ([1, 3, 17, 123, 99], None, dict(capacity=64)),
    # INT32_MIN and its neighbours, INT32_MAX, high hash bits, negatives
    "adversarial": ([1, 2, -2147483648, -2147483647, 2147483647, 2147483646,
                     0x40000000, 715827882, -809510276, 12345, -5, -77],
                    None, dict(capacity=64, probes=64)),
    "sentinel": ([5, 9], [-1, 5], dict()),
    "duplicates": ([5, 9, 5], [5, 9], dict()),
}


@pytest.mark.parametrize("case", sorted(KV_CASES))
def test_kv_store_cases(case):
    """The ``test_kv_store*`` cases: the hash of every key (negative keys
    and INT32_MIN included) and the placed table equal the reference's;
    every inserted key is found with its value (the last writer's for a
    duplicate); -1 is never found."""
    keys, query, kw = KV_CASES[case]
    keys = np.asarray(keys, np.int32)
    query = keys if query is None else np.asarray(query, np.int32)
    vals = np.random.default_rng(0).standard_normal(
        (len(keys), 4)).astype(np.float32)
    jt, jv, jcap = JKV.build_table(keys, vals, **kw)
    kv, table, st = TKV.build(keys, vals, num_sets=4, ways=2, device="cpu",
                              **kw)
    np.testing.assert_array_equal(table.numpy(), jt)
    np.testing.assert_array_equal(
        kv.array.storage.data.numpy().reshape(jcap, 4), jv)
    assert kv.capacity == jcap
    jkv = JKV(array=None, capacity=jcap, value_elems=4)
    np.testing.assert_array_equal(
        kv._hash_traced(torch.from_numpy(keys)).numpy(),
        np.asarray(jkv._hash_traced(jnp.asarray(keys))))
    assert [kv._hash_host(k, jcap) for k in keys.tolist()] \
        == [JKV._hash_host(k, jcap) for k in keys.tolist()]
    out, found, st = kv.lookup(st, table, torch.from_numpy(query))
    last = {int(k): vals[i] for i, k in enumerate(keys)}
    want_found = np.asarray([int(q) in last and q != -1 for q in query])
    np.testing.assert_array_equal(found.numpy(), want_found)
    for i, q in enumerate(query.tolist()):
        if want_found[i]:
            np.testing.assert_array_equal(out[i].numpy(), last[q])


def test_kv_store_build_rejects_sentinel_and_probe_overflow():
    cap, probes = 16, 4
    home = TKV._hash_host(3, cap)
    colliders = [k for k in range(1, 20000)
                 if TKV._hash_host(k, cap) == home][:probes + 1]
    vals = np.zeros((len(colliders), 4), np.float32)
    for mod in (TKV, JKV):
        with pytest.raises(ValueError, match="probes"):
            mod.build_table(np.asarray(colliders, np.int32), vals,
                            capacity=cap, probes=probes)
        with pytest.raises(ValueError, match="sentinel"):
            mod.build_table(np.asarray([-1, 5], np.int32), vals[:2])
    kv, table, st = TKV.build(np.asarray(colliders[:probes], np.int32),
                              vals[:probes], capacity=cap, probes=probes,
                              num_sets=4, ways=2, device="cpu")
    _, found, _ = kv.lookup(st, table, torch.tensor(colliders[:probes],
                                                    dtype=torch.int32))
    assert found.all()
