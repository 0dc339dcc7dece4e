"""Shared helpers for the differential tests of ``repro_torch`` against the
JAX package: state conversion to numpy, field-by-field comparison,
:class:`Both`, which drives one op on both packages and compares them, and
:class:`RtBoth`, the same for the multi-tenant runtime."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro_torch.interop import runtime_state_to_numpy, state_to_numpy

# Simulated-time fields: the time model's float32 charge is the same number
# in both packages, but the reference accumulates it in float32 and the port
# in float64, so sums of several rounds differ in the last float32 bits.
TIME_FIELDS = ("metrics.sim_time_s", "metrics.read_time_s",
               "metrics.write_time_s", "metrics.dev_time_s")
TIME_RTOL = 1e-6
TIME_NAMES = tuple(f.split(".")[1] for f in TIME_FIELDS)


def _is_time(key: str) -> bool:
    """A simulated-time field of the global or a tenant's metrics."""
    return key.split(".")[0] in ("metrics", "tenant_metrics") \
        and key.rsplit(".", 1)[1] in TIME_NAMES


def jax_state_to_numpy(st) -> dict:
    """The JAX package's ``BamState`` as the flat dict ``interop`` reads."""
    out = {}
    for prefix, obj in (("cache", st.cache), ("queues", st.queues),
                        ("metrics", st.metrics)):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if hasattr(v, "shape") and hasattr(v, "dtype"):
                out[f"{prefix}.{f.name}"] = np.asarray(v)
    return out


def jax_runtime_to_numpy(rst) -> dict:
    """The JAX package's ``RuntimeState`` as the flat dict
    ``interop.runtime_state_to_numpy`` gives."""
    out = jax_state_to_numpy(rst)
    for i, m in enumerate(rst.tenant_metrics):
        for f in dataclasses.fields(m):
            out[f"tenant_metrics.{i}.{f.name}"] = np.asarray(
                getattr(m, f.name))
    for i, s in enumerate(rst.storages):
        if s is not None:
            out[f"storages.{i}.data"] = np.asarray(s.data)
    return out


def _as_cmp(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype.kind == "f":
        return a.astype(np.float64)
    return a


def assert_fields_equal(port_obj, jax_obj, msg=""):
    """Every tensor field of a port dataclass bit-identical to the JAX
    dataclass's field of the same name."""
    import torch

    for f in dataclasses.fields(port_obj):
        a = getattr(port_obj, f.name)
        if not isinstance(a, torch.Tensor):
            assert a == getattr(jax_obj, f.name), f"{msg} {f.name}"
            continue
        a = a.detach().cpu()
        a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
        b = np.asarray(getattr(jax_obj, f.name))
        assert a.shape == b.shape, f"{msg} {f.name}: {a.shape} != {b.shape}"
        np.testing.assert_array_equal(_as_cmp(a), _as_cmp(b),
                                      err_msg=f"{msg} {f.name}")


def assert_metrics_equal(port_m, jax_m, msg=""):
    """Every ``IOMetrics`` field of the port equal to the reference's:
    counters exactly, time fields within ``TIME_RTOL``."""
    for f in dataclasses.fields(port_m):
        a = _as_cmp(getattr(port_m, f.name).detach().cpu().numpy())
        b = _as_cmp(getattr(jax_m, f.name))
        assert a.shape == b.shape, f"{msg} {f.name}: {a.shape} != {b.shape}"
        if f"metrics.{f.name}" in TIME_FIELDS:
            np.testing.assert_allclose(a, b, rtol=TIME_RTOL, atol=0,
                                       err_msg=f"{msg} {f.name}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{msg} {f.name}")


def assert_states_equal(port_st, jax_st, msg=""):
    """Every cache, queue and metric field bit-identical (integer-valued
    counters compared exactly across float64/float32), time fields within
    ``TIME_RTOL``."""
    assert_dicts_equal(state_to_numpy(port_st), jax_state_to_numpy(jax_st),
                       msg)


def assert_runtime_states_equal(port_rst, jax_rst, msg=""):
    """:func:`assert_states_equal` for a ``RuntimeState``: the shared cache
    and rings, the global and every tenant's metrics, and the
    device-resident tenant stores."""
    p, j = runtime_state_to_numpy(port_rst), jax_runtime_to_numpy(jax_rst)
    assert set(p) == set(j), sorted(set(p) ^ set(j))
    assert_dicts_equal(p, j, msg)


def assert_dicts_equal(p: dict, j: dict, msg=""):
    assert set(p) <= set(j), sorted(set(p) - set(j))
    for k in sorted(p):
        a, b = _as_cmp(p[k]), _as_cmp(j[k])
        assert a.shape == b.shape, f"{msg} {k}: shape {a.shape} != {b.shape}"
        if _is_time(k):
            np.testing.assert_allclose(a, b, rtol=TIME_RTOL, atol=0,
                                       err_msg=f"{msg} {k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{msg} {k}")


# XLA:CPU options for the reference's jitted ops: the older elemental
# emitters compile its many small fusions in about half the time of the
# fusion emitters, on one core.
REFERENCE_COMPILER_OPTIONS = {"xla_cpu_use_fusion_emitters": False}


@pytest.fixture(autouse=True, scope="module")
def fast_reference_compiles():
    """The reference runs here to be compared, not timed: compile it with
    XLA's optimisation passes mostly off, which about halves its compile
    time on one core, and with ``REFERENCE_COMPILER_OPTIONS`` (every
    top-level ``jax.jit`` made while a module runs; a nested one refuses
    compiler options), which halves it again.  Every comparison stays as
    strict as before."""
    import functools

    import jax

    prev = jax.config.read("jax_disable_most_optimizations")
    jit = jax.jit
    jax.config.update("jax_disable_most_optimizations", True)
    jax.jit = functools.partial(jit,
                                compiler_options=REFERENCE_COMPILER_OPTIONS)
    yield
    jax.jit = jit
    jax.config.update("jax_disable_most_optimizations", prev)


class Both:
    """Drive one op on both packages and compare everything after it: the
    values, the error and drop masks, and the whole cache, ring and
    ``IOMetrics`` state.  The reference runs through ``jax.jit`` of its own
    ``submit`` / ``wait_ex`` / ``flush`` (pinned bit-identical to its eager
    ops by its own tests), cached in the array's op cache; the port runs
    eagerly on the CPU.  Indices and payloads are numpy arrays."""

    def __init__(self, ja, js, ta, ts):
        self.ja, self.js, self.ta, self.ts = ja, js, ta, ts
        self.jsubmit = ja.submit_jit()
        self.jwait = ja._jit_op("wait_ex", lambda: ja.wait_ex)
        self.jflush = ja._jit_op("flush", lambda: ja.flush)

    def check(self, msg):
        assert_states_equal(self.ts, self.js, msg)

    def submit(self, kind, idx, values=None):
        import jax.numpy as jnp
        import torch
        from repro.core import IORequest as JReq
        from repro_torch.core.bam_array import IORequest as TReq

        jargs = [jnp.asarray(idx)]
        targs = [torch.from_numpy(idx)]
        if kind == "write":
            jargs.append(jnp.asarray(values))
            targs.append(torch.from_numpy(values))
        self.js, jt = self.jsubmit(self.js, getattr(JReq, kind)(*jargs))
        self.ts, tt = self.ta.submit(self.ts, getattr(TReq, kind)(*targs))
        self.check(f"submit {kind}")
        np.testing.assert_array_equal(tt.dropped_mask.numpy(),
                                      np.asarray(jt.dropped_mask))
        u = tt.ukeys.shape[0]
        np.testing.assert_array_equal(tt.ticket.numpy(),
                                      np.asarray(jt.ticket)[:u])
        assert (tt.ra_keys is None) == (jt.ra_keys is None)
        if tt.ra_keys is not None:
            np.testing.assert_array_equal(tt.ra_keys.numpy(),
                                          np.asarray(jt.ra_keys))
            np.testing.assert_array_equal(tt.ra_ticket.numpy(),
                                          np.asarray(jt.ra_ticket))
        return tt, jt

    def wait(self, toks):
        """Redeem a pair of tokens; returns the port's ``(values, err)``
        as numpy, after checking them against the reference's."""
        tt, jt = toks
        self.js, jv, je = self.jwait(self.js, jt)
        self.ts, tv, te = self.ta.wait_ex(self.ts, tt)
        self.check(f"wait {tt.kind}")
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        return tv.numpy(), te.numpy()

    def read(self, idx):
        return self.wait(self.submit("read", idx))[0]

    def write(self, idx, values):
        self.wait(self.submit("write", idx, values))

    def flush(self):
        self.js = self.jflush(self.js)
        self.ts = self.ta.flush(self.ts)
        self.check("flush")
        if self.ja.storage is not None:
            np.testing.assert_array_equal(self.ta.storage.data.numpy(),
                                          np.asarray(self.ja.storage.data))


class RtBoth:
    """Drive one ``BamRuntime`` op on both packages and compare the values
    and the whole runtime state after it (:func:`assert_runtime_states_equal`;
    after a drain also the completion stream, field by field in order).
    The reference runs through its own ``read_jit`` / ``write_jit`` /
    ``submit_jit`` and jitted ``wait_ex`` / ``prefetch`` / ``flush`` /
    ``drain``, cached in the runtime's op cache (pass ``shared`` to share
    it between runtimes of one static configuration on the ``hbm``
    backend, whose storage rides in the state).  Indices and payloads are
    numpy arrays."""

    def __init__(self, jrt, jrst, trt, trst, shared=None):
        if shared is not None:
            jrt._jit_ops = shared
        self.jrt, self.jrst, self.trt, self.trst = jrt, jrst, trt, trst

    def _op(self, key, make):
        return self.jrt._jit_op(key, make)

    def check(self, msg):
        assert_runtime_states_equal(self.trst, self.jrst, msg)
        self.trt.assert_metrics_consistent(self.trst)

    def read(self, name, idx):
        import jax.numpy as jnp
        import torch

        jv, self.jrst = self.jrt.read_jit(name)(self.jrst, jnp.asarray(idx))
        tv, self.trst = self.trt.read(self.trst, name, torch.from_numpy(idx))
        self.check(f"read {name}")
        assert tv.dtype == getattr(torch, str(jv.dtype))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        return tv.numpy()

    def write(self, name, idx, values):
        import jax.numpy as jnp
        import torch

        self.jrst = self.jrt.write_jit(name)(self.jrst, jnp.asarray(idx),
                                             jnp.asarray(values))
        self.trst = self.trt.write(self.trst, name, torch.from_numpy(idx),
                                   torch.from_numpy(values))
        self.check(f"write {name}")

    def prefetch(self, name, idx):
        import jax.numpy as jnp
        import torch

        jrt = self.jrt
        fn = self._op(f"prefetch:{name}", lambda: lambda rst, i:
                      jrt.prefetch(rst, name, i))
        self.jrst = fn(self.jrst, jnp.asarray(idx))
        self.trst = self.trt.prefetch(self.trst, name, torch.from_numpy(idx))
        self.check(f"prefetch {name}")

    def submit(self, name, idx):
        """Submit a read on both; returns the pair of tokens."""
        import jax.numpy as jnp
        import torch
        from repro.core import IORequest as JReq
        from repro_torch.core.bam_array import IORequest as TReq

        self.jrst, jt = self.jrt.submit_jit(name)(
            self.jrst, JReq.read(jnp.asarray(idx)))
        self.trst, tt = self.trt.submit(self.trst, name,
                                        TReq.read(torch.from_numpy(idx)))
        self.check(f"submit {name}")
        np.testing.assert_array_equal(tt.dropped_mask.numpy(),
                                      np.asarray(jt.dropped_mask))
        np.testing.assert_array_equal(
            tt.ticket.numpy(), np.asarray(jt.ticket)[:tt.ukeys.shape[0]])
        return tt, jt

    def wait(self, name, toks):
        """Redeem a pair of tokens; returns the port's ``(values, err)``."""
        tt, jt = toks
        jrt = self.jrt
        fn = self._op(f"wait_ex:{name}", lambda: lambda rst, tok:
                      jrt.wait_ex(rst, name, tok))
        self.jrst, jv, je = fn(self.jrst, jt)
        self.trst, tv, te = self.trt.wait_ex(self.trst, name, tt)
        self.check(f"wait {name}")
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        return tv.numpy(), te.numpy()

    def flush(self, name=None):
        jrt = self.jrt
        fn = self._op(f"flush:{name}", lambda: lambda rst:
                      jrt.flush(rst, name))
        self.jrst = fn(self.jrst)
        self.trst = self.trt.flush(self.trst, name)
        self.check(f"flush {name}")

    def drain(self):
        """Drain both; returns the port's ``Completions``."""
        fn = self._op("drain", lambda: self.jrt.drain)
        self.jrst, jc = fn(self.jrst)
        self.trst, tc = self.trt.drain(self.trst)
        self.check("drain")
        assert_fields_equal(tc, jc, "completions")
        return tc
