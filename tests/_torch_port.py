"""Shared helpers for the differential tests of ``repro_torch`` against the
JAX package: state conversion to numpy and field-by-field comparison."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro_torch.interop import state_to_numpy

# Simulated-time fields: the time model's float32 charge is the same number
# in both packages, but the reference accumulates it in float32 and the port
# in float64, so sums of several rounds differ in the last float32 bits.
TIME_FIELDS = ("metrics.sim_time_s", "metrics.read_time_s",
               "metrics.write_time_s", "metrics.dev_time_s")
TIME_RTOL = 1e-6


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
    p = state_to_numpy(port_st)
    j = jax_state_to_numpy(jax_st)
    assert set(p) <= set(j), sorted(set(p) - set(j))
    for k in sorted(p):
        a, b = _as_cmp(p[k]), _as_cmp(j[k])
        assert a.shape == b.shape, f"{msg} {k}: shape {a.shape} != {b.shape}"
        if k in TIME_FIELDS:
            np.testing.assert_allclose(a, b, rtol=TIME_RTOL, atol=0,
                                       err_msg=f"{msg} {k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{msg} {k}")


@pytest.fixture(autouse=True, scope="module")
def fast_reference_compiles():
    """The reference runs here to be compared, not timed: compile it with
    XLA's optimisation passes mostly off, which about halves its compile
    time on one core.  Every comparison stays as strict as before."""
    import jax

    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
