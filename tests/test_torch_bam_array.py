"""``repro_torch``'s BamArray against ``repro.core.BamArray`` (jnp oracles,
``kernel_impl="ref"``): sequences of submit / wait / read / write / flush
with several tokens outstanding, a resume from a JAX state through
``interop``, and the ``num_unique`` slicing.

Compared after every op: the values (exact: they are copies of stored
elements), the whole cache and ring state (bit-identical), ``IOMetrics``
(integer-valued counters exact, simulated-time fields within rtol 1e-6,
because the reference sums float32 charges in float32 and the port in
float64), and the storage bytes after ``flush`` (exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BamArray as JArray, IORequest as JReq
from repro.core.ssd import ArrayOfSSDs as JSSDs, INTEL_OPTANE_P5800X as JP58
from repro_torch.core.bam_array import BamArray as TArray, IORequest as TReq
from repro_torch.core.ssd import ArrayOfSSDs as TSSDs, INTEL_OPTANE_P5800X
from repro_torch.interop import state_from_numpy, state_to_numpy

from _torch_port import (  # noqa: F401
    assert_states_equal, fast_reference_compiles, jax_state_to_numpy)

jax.config.update("jax_platform_name", "cpu")

CFG = dict(block_elems=16, num_sets=8, ways=4, num_queues=4, queue_depth=8)
N = 64     # lanes per wavefront: one shape, so the reference compiles once


SIZE = 2000


@pytest.fixture(scope="module")
def ref_array():
    """One reference array, and so one set of jit-compiled submit/wait, for
    the tests below.  Each test starts from the initial state; writes reach
    the reference's host storage, so each port array starts from a copy of
    that storage as it stands."""
    data = (np.random.default_rng(0).standard_normal(SIZE) * 100).astype(
        np.float32)
    ja, js0 = JArray.build(data, ssd=JSSDs(JP58, 2), kernel_impl="ref",
                           **CFG)
    return ja, js0


def _port_like(ja):
    host = np.asarray(ja.storage.data).reshape(-1)[:SIZE].copy()
    ta, ts = TArray.build(host, ssd=TSSDs(INTEL_OPTANE_P5800X, 2),
                          device="cpu", **CFG)
    return ta, ts, host


class Both:
    """Drive one op on both packages and compare everything after it.  The
    reference runs through its own jit-cached ``submit_jit``/``wait_jit``
    (pinned bit-identical to its eager ops by its own tests); ``read`` and
    ``write`` are submit + wait on both sides, as the shims are."""

    def __init__(self, ja, js, ta, ts):
        self.ja, self.js, self.ta, self.ts = ja, js, ta, ts
        self.jsubmit, self.jwait = ja.submit_jit(), ja.wait_jit()

    def check(self, msg, tv=None, jv=None):
        assert_states_equal(self.ts, self.js, msg)
        if tv is not None:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                          err_msg=f"{msg} values")

    def submit(self, kind, idx, values=None, valid=None):
        if kind == "read":
            jr = JReq.read(jnp.asarray(idx), None if valid is None
                           else jnp.asarray(valid))
            tr = TReq.read(torch.from_numpy(idx), None if valid is None
                           else torch.from_numpy(valid))
        else:
            jr = JReq.write(jnp.asarray(idx), jnp.asarray(values))
            tr = TReq.write(torch.from_numpy(idx), torch.from_numpy(values))
        self.js, jt = self.jsubmit(self.js, jr)
        self.ts, tt = self.ta.submit(self.ts, tr)
        self.check(f"submit {kind}")
        np.testing.assert_array_equal(tt.dropped_mask.numpy(),
                                      np.asarray(jt.dropped_mask))
        return tt, jt

    def wait(self, toks):
        tt, jt = toks
        self.js, jv = self.jwait(self.js, jt)
        self.ts, tv = self.ta.wait(self.ts, tt)
        self.check("wait", tv, jv)
        return tv

    def read(self, idx):
        return self.wait(self.submit("read", idx))

    def write(self, idx, values):
        self.wait(self.submit("write", idx, values))

    def flush(self):
        self.js = self.ja.flush(self.js)
        self.ts = self.ta.flush(self.ts)
        self.check("flush")
        np.testing.assert_array_equal(self.ta.storage.data.numpy(),
                                      np.asarray(self.ja.storage.data))


def _idx(rng, n, unique=False):
    return rng.choice(SIZE, n, replace=not unique).astype(np.int32)


def test_outstanding_tokens_read_write_flush(ref_array):
    rng = np.random.default_rng(0)
    ja, js0 = ref_array
    ta, ts, shadow = _port_like(ja)
    b = Both(ja, js0, ta, ts)
    t_a = b.submit("read", _idx(rng, N))
    w_idx = _idx(rng, N, unique=True)
    w_val = (rng.standard_normal(N) * 5).astype(np.float32)
    t_b = b.submit("write", w_idx, w_val)
    shadow[w_idx] = w_val
    r_idx = np.concatenate([w_idx[:20], _idx(rng, N - 20)])
    t_c = b.submit("read", r_idx)
    b.wait(t_b)
    b.wait(t_a)
    vals_c = b.wait(t_c)
    np.testing.assert_array_equal(vals_c.numpy()[:20], w_val[:20])
    for _ in range(3):
        idx = _idx(rng, N)
        np.testing.assert_array_equal(b.read(idx).numpy(), shadow[idx])
        w_idx = _idx(rng, N, unique=True)
        w_val = (rng.standard_normal(N) * 5).astype(np.float32)
        b.write(w_idx, w_val)
        shadow[w_idx] = w_val
    assert float(b.ts.metrics.dropped) > 0, "rings should overflow"
    assert float(b.ts.metrics.write_ops) > 0
    b.flush()
    np.testing.assert_array_equal(
        b.ta.storage.data.numpy().reshape(-1)[:SIZE], shadow)
    # a token may be redeemed once
    tok = b.submit("read", _idx(rng, N))
    b.wait(tok)
    with pytest.raises(ValueError, match="already been redeemed"):
        b.ta.wait(b.ts, tok[0])


def test_resume_from_jax_state_through_interop(ref_array):
    """Run the reference for a while, carry its state (and storage) across
    as numpy, then continue both packages in lockstep."""
    rng = np.random.default_rng(1)
    ja, js = ref_array
    jsubmit, jwait = ja.submit_jit(), ja.wait_jit()
    for _ in range(3):
        js, jt = jsubmit(js, JReq.read(jnp.asarray(_idx(rng, N))))
        js, _ = jwait(js, jt)
        w = _idx(rng, N, unique=True)
        js, jt = jsubmit(js, JReq.write(jnp.asarray(w), jnp.asarray(
            rng.standard_normal(N).astype(np.float32))))
        js, _ = jwait(js, jt)
    ta, _, _ = _port_like(ja)
    ts = state_from_numpy(jax_state_to_numpy(js), device="cpu")
    assert_states_equal(ts, js, "resumed state")
    back = state_to_numpy(ts)
    for k, v in jax_state_to_numpy(js).items():
        np.testing.assert_array_equal(back[k].astype(np.float64),
                                      v.astype(np.float64), err_msg=k)
    b = Both(ja, js, ta, ts)
    for _ in range(2):
        b.read(_idx(rng, N))
        w = _idx(rng, N, unique=True)
        b.write(w, (rng.standard_normal(N)).astype(np.float32))
    b.flush()


def test_num_unique_slicing_wide_wavefront(ref_array):
    """A 4000-lane wavefront over four lines (plus invalid lanes) and an
    all-invalid one: the port sizes its buffers by the unique-line count,
    the reference by the lane count, and every value, metric and cache and
    ring field still agrees."""
    rng = np.random.default_rng(2)
    ja, js0 = ref_array
    ta, ts, host = _port_like(ja)
    b = Both(ja, js0, ta, ts)
    idx = rng.choice(np.array([5, 7, 40, 41, 900, 913]), 4000).astype(np.int32)
    idx[::7] = -1
    tok = b.submit("read", idx)
    assert tok[0].ukeys.shape[0] == 4 and tok[1].ukeys.shape[0] == 4000
    vals = b.wait(tok)
    np.testing.assert_array_equal(vals.numpy(),
                                  np.where(idx >= 0, host[idx], 0))
    tok = b.submit("read", np.full(4000, -1, np.int32))
    assert tok[0].ukeys.shape[0] == 1
    b.wait(tok)
    empty = b.submit("read", np.zeros(0, np.int32))
    assert b.wait(empty).shape == (0,)


def test_storage_backends_match_reference():
    """Both stores against the reference's: fetch with sentinel keys, then
    write and fetch again."""
    from repro.core.storage import HBMStorage as JH, SimStorage as JS
    from repro_torch.core.storage import HBMStorage as TH, SimStorage as TS

    rng = np.random.default_rng(4)
    arr = rng.standard_normal(203).astype(np.float32)
    # no block 0 here: the reference's HBMStorage.write_blocks sends
    # sentinel rows to block 0 as well, so a real write to block 0 in the
    # same call may be lost there (scatter order); the port writes only
    # keys >= 0
    keys = np.array([3, -1, 1, 12, 7, -1], np.int32)
    lines = rng.standard_normal((6, 16)).astype(np.float32)
    jh, th = JH.from_array(jnp.asarray(arr), 16), TH.from_array(arr, 16, "cpu")
    js, ts = JS.from_array(arr.copy(), 16), TS.from_array(arr, 16, "cpu")
    for j, t in ((jh, th), (js, ts)):
        np.testing.assert_array_equal(
            t.fetch_blocks(torch.from_numpy(keys)).numpy(),
            np.asarray(j.fetch_blocks(jnp.asarray(keys))))
    jh = jh.write_blocks(jnp.asarray(keys), jnp.asarray(lines))
    th.write_blocks(torch.from_numpy(keys), torch.from_numpy(lines))
    js._host_write(keys, lines)
    ts.write_blocks(torch.from_numpy(keys), torch.from_numpy(lines))
    np.testing.assert_array_equal(th.data.numpy(), np.asarray(jh.data))
    np.testing.assert_array_equal(ts.data.numpy(), js.data)


def test_hbm_backend_matches_sim_backend():
    """The device-resident store gives the same values, state and final
    bytes as the host store (port only: the stores themselves are held
    against the reference above)."""
    rng = np.random.default_rng(3)
    data = rng.standard_normal(600).astype(np.float32)
    arrs = [TArray.build(data, ssd=TSSDs(INTEL_OPTANE_P5800X, 1),
                         device="cpu", backend=be, **CFG)
            for be in ("sim", "hbm")]
    for _ in range(3):
        idx = torch.from_numpy(_idx(rng, N) % 600)
        w = torch.from_numpy(rng.choice(600, N, replace=False).astype(
            np.int32))
        vals = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
        outs = []
        for i, (a, st) in enumerate(arrs):
            v, st = a.read(st, idx)
            st = a.write(st, w, vals)
            arrs[i] = (a, st)
            outs.append(v)
        assert torch.equal(outs[0], outs[1])
    (sa, ss), (ha, hs) = arrs
    ss, hs = sa.flush(ss), ha.flush(hs)
    a, b = state_to_numpy(ss), state_to_numpy(hs)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert torch.equal(sa.storage.data, hs.storage.data)


def test_unported_options_raise():
    from repro_torch.core.prefetch import PrefetchConfig
    from repro_torch.core.ssd import FaultModel

    data = np.zeros(64, np.float32)
    with pytest.raises(NotImplementedError):
        TArray.build(data, device="cpu", prefetch=PrefetchConfig(True), **CFG)
    with pytest.raises(NotImplementedError):
        TArray.build(data, device="cpu", fused_rounds=False, **CFG)
    with pytest.raises(NotImplementedError):
        TArray.build(data, device="cpu", ssd=TSSDs(
            INTEL_OPTANE_P5800X, 2, fault=FaultModel(failed_devices=(1,))),
            **CFG)
    ta, ts = TArray.build(data, device="cpu", **CFG)
    with pytest.raises(NotImplementedError):
        ta.submit(ts, TReq.prefetch(torch.arange(4)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TArray.build(data, **CFG)
