"""Shared helpers for the differential tests of ``repro_torch`` against the
JAX package: state conversion to numpy, field-by-field comparison,
:class:`Both`, which drives one op on both packages and compares them, and
:class:`RtBoth`, the same for the multi-tenant runtime."""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.interop import runtime_state_to_numpy, state_to_numpy

# One intra-op thread: the tests' tensors are small, and PyTorch's default
# of a thread a core left every xdist worker's pool spinning against the
# others' (the port's test files took 809 s of CPU for 113 s of wall with
# 6 workers on 8 cores, 375 s for 67 s with one thread).
torch.set_num_threads(1)

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


# ------------------------------------------------ mesh test helpers ----
def reference_axes(name):
    """The JAX package's (parameter shapes, logical-axes tree) of a smoke
    config, traced without running its initialiser."""
    import jax
    from repro.configs.base import smoke_config
    from repro.models.model import build_model

    api = build_model(smoke_config(name))
    box = {}

    def init(key):
        params, box["axes"] = api.init(key, 16)
        return params
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return shapes, box["axes"]


def ref_node(tree, path, stacked):
    """The node of the reference's tree for a port parameter's path (the
    layer index dropped where the reference stacks its blocks)."""
    from repro_torch.interop import STACKED

    keys = (path[0],) + path[2:] if path[0] in STACKED and stacked \
        else path
    for k in keys:
        tree = tree[k]
    return tree


def flash_decode_inputs() -> dict:
    """A paged decode case for the sharded flash-decoding: 3 sequences of 6
    pages of 8 over 8 physical pages, a hole, the last sequence empty."""
    rng = np.random.default_rng(0)
    B, Hq, Hkv, D, Pp, page, NP = 3, 4, 2, 16, 8, 8, 6
    f32 = np.float32
    pt = np.stack([rng.permutation(Pp)[:NP] for _ in range(B)])
    pt[1, 2] = -1                                       # a hole
    return {"q": rng.standard_normal((B, Hq, D)).astype(f32),
            "k_pages": rng.standard_normal((B, Pp, page, Hkv, D)).astype(f32),
            "v_pages": rng.standard_normal((B, Pp, page, Hkv, D)).astype(f32),
            "page_table": pt.astype(np.int32),
            # the last row has no live key
            "seq_lens": np.asarray([37, 44, 0], np.int32)}


# ------------------------------------------------- distributed checks ----
# ``tests/test_torch_distributed.py`` and ``tests/test_torch_tp_recurrent.py``
# each run their checks that need processes in one gloo group of DIST_WORLD
# ranks on the CPU: ``dist_main`` (its own interpreter, which never imports
# jax) imports the port once, forks the ranks and waits for them; each rank
# runs every check of its DIST_GROUPS entry in order (the collectives need
# every rank in step) and saves what it found to ``rank<r>.pt``; the test
# process compares that with the JAX package.
DIST_WORLD = 8
DIST_TIMEOUT_S = 240


def _dist_cfg(name, **kw):
    from repro_torch.configs import smoke_config
    return smoke_config(name).replace(**kw)


def _dist_state(cfg, seed, acfg, mesh=None, moments=False):
    """A fresh training state of ``cfg`` from ``seed`` (the same on every
    rank), sharded on ``mesh`` when one is given; and its shardings.  The
    moments are adamw_init's zeros, or with ``moments`` random values in
    [0, 1) (for the checkpoint checks, where zeros would hide a mix-up)."""
    import torch
    from repro_torch.interop import param_axes
    from repro_torch.models.model import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import shard_state, state_shardings

    api = build_model(cfg, "cpu")
    model = api.init(seed, 16).requires_grad_(True)
    state = {"params": model, "opt": opt.adamw_init(model, acfg)}
    gen = torch.Generator().manual_seed(seed + 1)
    for key in ("mu", "nu") if moments else ():
        for t in state["opt"][key].values():
            t.copy_(torch.rand(t.shape, generator=gen))
    if mesh is None:
        return api, state, None
    sh = state_shardings(cfg, param_axes(model), mesh, model, acfg)
    return api, shard_state(state, sh), sh


def _gathered_numpy(tensors: dict) -> dict:
    from repro_torch.distributed.sharding import full
    return {n: full(t).detach().numpy().copy() for n, t in tensors.items()}


def _local_numpy(tensors: dict) -> dict:
    return {n: t.to_local().detach().numpy().copy()
            for n, t in tensors.items()}


class _LargestTensor:
    """A dispatch walk that keeps the most elements of any tensor an op
    made (a DTensor op's output counts its local tensor; a tensor on
    ``meta`` holds nothing and is left out), but for tensors of the shapes
    in ``skip``: those of the parameters that every rank holds whole
    (xLSTM's ``r`` where the ranks do not divide its heads), whose
    gradients and moments are whole too."""

    def __init__(self, skip=()):
        self.skip = frozenset(skip)

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        walk = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in tree_leaves(out):
                    if isinstance(t, torch.Tensor):
                        t = t.to_local() if hasattr(t, "to_local") else t
                        if t.device.type != "meta" and \
                                tuple(t.shape) not in walk.skip:
                            walk.numel = max(walk.numel, t.numel())
                return out

        self.numel, self.mode = 0, Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def _run_mesh_step(shape, names, acfg, tokens, steps, arch="qwen2.5-14b",
                   **cfg_kw):
    """``steps`` mesh steps of ``arch``'s smoke config on a mesh of
    ``shape``: every rank's metrics, coordinate and local update of each
    parameter (after minus before, f64); the gathered parameters and the
    opt state's DTensors after the steps; the shapes of the step's work
    copy (``train_step.work``) and the most elements of any tensor the
    steps made (but for those of the shape of a parameter the spec leaves
    whole over ``model``)."""
    import numpy as np
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.train_loop import make_train_step

    mesh = make_mesh(shape, names, "cpu")
    cfg = _dist_cfg(arch, **cfg_kw)
    api, state, _ = _dist_state(cfg, 0, acfg, mesh)
    whole = {tuple(p.shape) for p in state["params"].parameters()
             if not tp.model_dims(shd.spec_of(p))}
    before = {n: v.astype(np.float64) for n, v in _local_numpy(
        dict(state["params"].named_parameters())).items()}
    step = make_train_step(cfg, api, adamw=acfg, mesh=mesh)
    batch = {"tokens": torch.from_numpy(tokens)}
    metrics = []
    with _LargestTensor(whole) as walk:
        for _ in range(steps):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    after = _local_numpy(dict(state["params"].named_parameters()))
    return mesh, state, {
        "metrics": metrics, "coord": mesh.get_coordinate(),
        "update": {n: after[n] - before[n] for n in after},
        "params": _gathered_numpy(dict(state["params"].named_parameters())),
        "work_shapes": {n: tuple(p.shape) for n, p in
                        step.work["model"].named_parameters()},
        "largest": walk.numel}


def _check_mesh_step(rank, inp, work):
    """qwen2.5-14b's smoke config, two steps on a (2, 4) data/model mesh
    from zero moments."""
    from repro_torch.training import optimizer as opt

    acfg = opt.AdamWConfig(lr=1e-3, warmup=1, total_steps=10)
    _, state, out = _run_mesh_step((2, 4), ("data", "model"), acfg,
                                   inp["tokens"], 2)
    out["mu"] = _gathered_numpy(state["opt"]["mu"])
    if rank:
        del out["params"], out["mu"]
    return out


def _check_moe_step(rank, inp, work):
    """olmoe-1b-7b's smoke config, two steps on a (2, 4) data/model mesh
    from zero moments: the batch split over data 2, so the router's
    statistics are summed over the two slices."""
    from repro_torch.training import optimizer as opt

    acfg = opt.AdamWConfig(lr=1e-3, warmup=1, total_steps=10)
    _, _, out = _run_mesh_step((2, 4), ("data", "model"), acfg,
                               inp["tokens"], 2, arch="olmoe-1b-7b")
    if rank:
        del out["params"]
    return out


TP_SOFTCAP = 30.0       # gemma3's tensor-parallel check: a logit softcap


def _tp_step(rank, inp, arch, **cfg_kw):
    """``arch``'s smoke config, two steps on a (2, 4) data/model mesh from
    zero moments."""
    from repro_torch.training import optimizer as opt

    acfg = opt.AdamWConfig(lr=1e-3, warmup=1, total_steps=10)
    _, _, out = _run_mesh_step((2, 4), ("data", "model"), acfg,
                               inp["tokens"], 2, arch=arch, **cfg_kw)
    if rank:
        del out["params"]
    return out


def _check_tp_gemma3(rank, inp, work):
    """gemma3-12b's smoke config (window layers, tied vocab-parallel table)
    with a logit softcap."""
    return _tp_step(rank, inp, "gemma3-12b", logit_softcap=TP_SOFTCAP)


def _check_tp_hymba(rank, inp, work):
    """hymba-1.5b's smoke config: over model 4 ranks 0-1 hold only xm's
    columns of each ``mamba.w_in``, ranks 2-3 only z's."""
    return _tp_step(rank, inp, "hymba-1.5b")


def _check_tp_xlstm(rank, inp, work):
    """xlstm-1.3b's smoke config: 2 heads over model 4, half a head a
    rank (the gathered-heads path)."""
    return _tp_step(rank, inp, "xlstm-1.3b")


TP_DECODE_STEPS = 4
# qwen2.5-14b's smoke config with 10 q heads over 5 kv heads of 8: over
# model 4 a rank's rows of wo are 2.5 heads, so each rank attends on 3 q
# heads that straddle two GQA groups unaligned (rank 1's [2, 5) use kv
# heads 1, 1, 2: a kv head a q head)
TP_STRADDLE = dict(n_heads=10, n_kv_heads=5, head_dim=8)
TP_CONFIGS = {"qwen2.5-14b": ("qwen2.5-14b", {}),
              "gemma3-12b": ("gemma3-12b", {"flash_decode_shards": True}),
              "straddle": ("qwen2.5-14b", TP_STRADDLE)}
# the hybrid and SSM families, in a gloo group of their own
# (``tests/test_torch_tp_recurrent.py``)
TP_RECURRENT = {"hymba-1.5b": ("hymba-1.5b", {}),
                "xlstm-1.3b": ("xlstm-1.3b", {})}


def _decode_run(cfg, model, prompt, feed=None):
    """``forward(last_only=True)``'s logits of ``prompt`` (B, S), then
    ``prefill``'s and TP_DECODE_STEPS decode steps' (as numpy), each step
    fed the argmax of ``feed``'s logits of the step before (this run's own
    where ``feed`` is None).  hymba and xLSTM have no ``prefill``: the
    prompt goes through decode steps a token at a time (after hymba's
    meta tokens, ``prime_cache``), the last step's logits in its place;
    ``state_shapes`` are then the shapes of each layer's recurrent state
    at the end (hymba's conv and SSM states, xLSTM's cell states)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.model import family_module

    mod, _ = family_module(cfg)
    batch = {"tokens": torch.from_numpy(prompt)}
    with torch.no_grad():
        fwd, _ = mod.forward(cfg, model, batch, last_only=True)
        if mod is T:
            logits, cache = T.prefill(cfg, model, batch, 64)
        else:
            cache = mod.init_decode_cache(cfg, prompt.shape[0], 64, "cpu")
            if cfg.n_meta_tokens:
                cache = mod.prime_cache(cfg, model, cache)
            for t in batch["tokens"].unbind(1):
                logits, cache = mod.decode_step(cfg, model, cache, t)
        steps = [logits.numpy()]
        for i in range(TP_DECODE_STEPS):
            tok = (feed or steps)[i].argmax(-1)
            logits, cache = mod.decode_step(cfg, model, cache,
                                            torch.from_numpy(tok))
            steps.append(logits.numpy())
    out = {"forward": fwd[:, 0].numpy(), "steps": steps}
    if mod is not T:
        out["state_shapes"] = [
            {k: tuple(v.shape) for k, v in layer[1].items()}
            if isinstance(layer, tuple) else
            [tuple(v.shape) for v in layer.value]
            for layer in cache["layers"]]
    return out


def _straddle_step(tokens, mesh=None):
    """One train step of the ``straddle`` config from zero moments, plain
    or on ``mesh``: its metrics and the parameters gathered after it."""
    import torch
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step

    acfg = opt.AdamWConfig(lr=1e-3, warmup=1, total_steps=10)
    cfg = _dist_cfg("qwen2.5-14b", **TP_STRADDLE)
    api, state, _ = _dist_state(cfg, 0, acfg, mesh)
    state, met = make_train_step(cfg, api, adamw=acfg, mesh=mesh)(
        state, {"tokens": torch.from_numpy(tokens)})
    params = dict(state["params"].named_parameters())
    return {"metrics": {k: float(v) for k, v in met.items()},
            "params": (_gathered_numpy(params) if mesh is not None else
                       {n: p.detach().numpy().copy()
                        for n, p in params.items()})}


def tp_plain_runs(prompt, tokens, configs=None) -> dict:
    """The plain path of what ``_check_tp_decode`` (``configs`` None) or
    ``_check_tp_recurrent_decode`` (TP_RECURRENT) runs tensor-parallel,
    once in the test process (every rank would make the same): each
    config's :func:`_decode_run` from ``api.init(0)``, and for the
    former the ``straddle`` config's :func:`_straddle_step` under
    ``train``."""
    from repro_torch.models.model import build_model

    out = {}
    for key, (arch, kw) in (configs or TP_CONFIGS).items():
        cfg = _dist_cfg(arch, **kw)
        out[key] = _decode_run(cfg, build_model(cfg, "cpu").init(0), prompt)
    if configs is None:
        out["train"] = _straddle_step(tokens)
    return out


def _tp_decode_runs(configs, inp, mesh) -> dict:
    """Each of ``configs``' smoke models tensor-parallel on ``mesh`` from
    the mesh step's work copy of the sharded parameters: its
    :func:`_decode_run` (each step fed the plain path's argmax,
    ``inp["tp_plain"]`` from :func:`tp_plain_runs`) and the local copy's
    parameter shapes."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.interop import param_axes
    from repro_torch.models.model import build_model
    from repro_torch.training.train_loop import (load_work, shard_state,
                                                 work_copy)

    out = {}
    for key, (arch, kw) in configs.items():
        cfg = _dist_cfg(arch, **kw)
        api = build_model(cfg, "cpu")
        sharded = api.init(0)
        sh = shd.param_shardings(param_axes(sharded), mesh,
                                 shapes=dict(sharded.named_parameters()))
        sharded = shard_state({"params": sharded, "opt": {}},
                              {"params": sh})["params"]
        local = work_copy(cfg, sharded, mesh, blocks_sharded=False
                          ).requires_grad_(False)
        load_work(cfg, local, sharded, mesh)
        with tp.activate(mesh), (shd.activate(mesh)
                                 if cfg.flash_decode_shards
                                 else contextlib.nullcontext()):
            out[key] = _decode_run(cfg, local, inp["prompt"],
                                   inp["tp_plain"][key]["steps"])
        out[key]["work_shapes"] = {n: tuple(p.shape) for n, p in
                                   local.named_parameters()}
    return out


def _check_tp_decode(rank, inp, work):
    """TP_CONFIGS' smoke models (gemma3-12b with ``flash_decode_shards``)
    through :func:`_tp_decode_runs` on the (2, 4) mesh, and the
    ``straddle`` config's train step on it."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    out = _tp_decode_runs(TP_CONFIGS, inp, mesh)
    out["train"] = _straddle_step(inp["tokens"], mesh)
    return out


def _check_tp_recurrent_decode(rank, inp, work):
    """TP_RECURRENT's smoke models through :func:`_tp_decode_runs`: hymba's
    conv and SSM states and xLSTM's cell states on the rank's channels and
    heads, on the (2, 4) mesh."""
    from repro_torch.launch.mesh import make_mesh

    return _tp_decode_runs(TP_RECURRENT, inp, make_mesh(
        (2, 4), ("data", "model"), "cpu"))


def _check_pod_step(rank, inp, work):
    """One pod-compressed step on a (2, 2, 2) pod/data/model mesh from zero
    moments and residuals."""
    from repro_torch.training import optimizer as opt

    acfg = opt.AdamWConfig(lr=1e-3, warmup=1, total_steps=10,
                           pod_compression=True)
    mesh, state, out = _run_mesh_step((2, 2, 2), ("pod", "data", "model"),
                                      acfg, inp["tokens"], 1)
    out.update(metrics=out["metrics"][0], pod=mesh.get_local_rank("pod"),
               ef=_gathered_numpy(state["opt"]["ef"]),
               local_ef=_local_numpy(state["opt"]["ef"]))
    if mesh.get_local_rank("model"):
        del out["params"], out["ef"]
    return out


def _check_reshard(rank, inp, work):
    """A state saved from a (4, 2) mesh, restored onto (2, 2) (ranks 0-3)
    with ``elastic_restore``."""
    from repro_torch.interop import param_axes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import optimizer as opt
    from repro_torch.training.checkpoint import save_checkpoint
    from repro_torch.training.fault_tolerance import elastic_restore
    from repro_torch.training.train_loop import state_shardings

    cfg = _dist_cfg("gemma3-1b")
    acfg = opt.AdamWConfig()
    mesh42 = make_mesh((4, 2), ("data", "model"), "cpu")
    _, st, _ = _dist_state(cfg, 0, acfg, mesh42, moments=True)
    saved = {"params": _gathered_numpy(dict(st["params"]
                                            .named_parameters())),
             "mu": _gathered_numpy(st["opt"]["mu"])}
    save_checkpoint(f"{work}/ckpt42", 3, st)
    mesh22 = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {"saved": saved} if rank == 0 else {}
    if mesh22.get_coordinate() is None:
        return out
    _, template, _ = _dist_state(cfg, 7, acfg)       # other values, plain

    def shardings(m):
        model = template["params"]
        return state_shardings(cfg, param_axes(model), m, model, acfg)

    st22, step, _ = elastic_restore(f"{work}/ckpt42", template, shardings,
                                    mesh22)
    out.update(step=step, coord=mesh22.get_coordinate(),
               local=_local_numpy(dict(st22["params"].named_parameters())),
               local_mu=_local_numpy(st22["opt"]["mu"]),
               params=_gathered_numpy(dict(st22["params"]
                                           .named_parameters())),
               mu=_gathered_numpy(st22["opt"]["mu"]))
    return out


def _check_jax_checkpoint(rank, inp, work):
    """The JAX package's checkpoint of gemma3-1b's smoke state restored
    onto a (2, 2) mesh (ranks 0-3)."""
    from repro_torch.interop import param_axes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import optimizer as opt
    from repro_torch.training.checkpoint import restore_checkpoint
    from repro_torch.training.train_loop import state_shardings

    mesh22 = make_mesh((2, 2), ("data", "model"), "cpu")
    if mesh22.get_coordinate() is None:
        return {}
    cfg = _dist_cfg("gemma3-1b")
    acfg = opt.AdamWConfig()
    _, template, _ = _dist_state(cfg, 7, acfg)
    model = template["params"]
    sh = state_shardings(cfg, param_axes(model), mesh22, model, acfg)
    st, step, _ = restore_checkpoint(inp["jax_ckpt"], template,
                                     shardings=sh)
    return {"step": step, "coord": mesh22.get_coordinate(),
            "local": _local_numpy(dict(st["params"].named_parameters())),
            "mu": _local_numpy(st["opt"]["mu"]),
            "nu": _local_numpy(st["opt"]["nu"])}


def _check_flash_decode(rank, inp, work):
    """Shard-local flash-decoding on model 4 of a (2, 4) mesh from pools
    split on the page axis; whole pools raise."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T

    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    cfg = _dist_cfg("gemma3-12b", flash_decode_shards=True)
    q, kp, vp, pt, sl = (torch.from_numpy(inp[k]) for k in
                         ("q", "k_pages", "v_pages", "page_table",
                          "seq_lens"))
    sh = shd.NamedSharding(mesh, T.POOL_SPEC)
    split = T._paged_attention_flash_decode(
        cfg, q, shd.shard(kp, sh), shd.shard(vp, sh), pt, sl, mesh)
    try:
        T._paged_attention_flash_decode(cfg, q, kp, vp, pt, sl, mesh)
        whole = None
    except ValueError as e:
        whole = str(e)
    x = torch.arange(4 * 25 * 8, dtype=torch.float32).reshape(4, 25, 8)
    with shd.activate(mesh):
        y = shd.constrain(shd.shard(x, shd.NamedSharding(mesh, ())),
                          ("batch", "act_heads", None))
    return {"split": split.numpy(), "whole_raised": whole,
            "constrained_spec": shd.spec_of(y),
            "constrained_same": bool(torch.equal(y.full_tensor(), x))}


def _check_decode_step(rank, inp, work):
    """qwen2.5-14b's smoke model with ``flash_decode_shards``: a prompt
    through ``prefill`` under the (2, 4) mesh (pools split over model 4)
    and without a mesh."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model

    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    cfg = _dist_cfg("qwen2.5-14b", flash_decode_shards=True)
    model = build_model(cfg, "cpu").init(0)
    batch = {"tokens": torch.from_numpy(inp["prompt"])}
    plain, _ = T.prefill(cfg, model, batch, 64)
    with shd.activate(mesh):
        sharded, cache = T.prefill(cfg, model, batch, 64)
    pools = [t.value["k_pages"] for t in cache["layers"]
             if t.kind == "paged"]
    return {"plain": plain.numpy(), "sharded": sharded.numpy(),
            "local_pages": [tuple(p.to_local().shape) for p in pools],
            "pool_spec": [shd.spec_of(p) for p in pools]}


def _check_gpipe(rank, inp, work):
    """GPipe over the pod axis of a (4, 2) pod/data mesh, P 4, M 8."""
    import torch
    from repro_torch.distributed.pipeline_parallel import gpipe
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((4, 2), ("pod", "data"), "cpu")
    pipe = gpipe(lambda w, xb: torch.tanh(xb @ w), 4, 8, mesh=mesh)
    return {"y": pipe(torch.from_numpy(inp["ws"]),
                      torch.from_numpy(inp["x"])).numpy()}


def _check_pod_mean(rank, inp, work):
    """``pod_compressed_mean`` over the pod axis of (2, 2, 2): each pod's
    gradient and residual from the inputs."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.optimizer import pod_compressed_mean

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    p = mesh.get_local_rank("pod")
    g = {k: torch.from_numpy(v[p]) for k, v in inp["pod_g"].items()}
    e = {k: torch.from_numpy(v[p]) for k, v in inp["pod_e"].items()}
    mean, ef = pod_compressed_mean(g, e, "pod", mesh)
    return {"pod": p, "mean": {k: v.numpy() for k, v in mean.items()},
            "ef": {k: v.numpy() for k, v in ef.items()}}


def _check_launch_train(rank, inp, work):
    """``launch/train --mesh 2x4 --smoke --device cpu`` for 3 steps."""
    from repro_torch.launch import train as launch_train

    args = launch_train.parser().parse_args(inp["launch_argv"] + [
        "--mesh", "2x4", "--workdir", f"{work}/launch"])
    res = launch_train.run(args)
    return {"losses": [m["loss"] for m in res.metrics_history],
            "step": res.step}


# --------------------------------------------------- ZeRO-3 block by block --
# tests/test_torch_fsdp.py's group: the mesh step on meshes whose data axis
# splits the blocks' weights, each check's arch, mesh (data, model) and
# steps (two: the second step's gathers must see the first's update of
# the shards in place)
FSDP_CASES = {"fsdp_qwen": ("qwen2.5-14b", (8, 1), 2),
              "fsdp_hymba": ("hymba-1.5b", (4, 2), 2),
              "fsdp_xlstm": ("xlstm-1.3b", (4, 2), 2)}


@contextlib.contextmanager
def watch_blocks(rec: dict, fault=None):
    """Wrap ``fsdp.gather_block`` and ``fsdp.scatter_block`` with a watcher
    that holds weak references to the storages each block's gather made
    and to the whole gradients each block's scatter took.  At every
    gather and scatter it counts, in ``rec``, the other blocks' gathered
    weights and whole gradients still alive (``overlap_fwd``,
    ``overlap_recompute``: a gather in the backward is remat's recompute;
    ``grads_alive``), and the gathers and scatters of each phase.
    ``fault(plan, grads)``, when given, replaces the scatter of the blocks
    it does not return None for (a planted fault)."""
    import weakref

    from repro_torch.distributed import fsdp

    gather0, scatter0 = fsdp.gather_block, fsdp.scatter_block
    gathered, whole = [], []
    for k in ("gathers_fwd", "gathers_recompute", "scatters",
              "overlap_fwd", "overlap_recompute", "grads_alive"):
        rec.setdefault(k, 0)

    def others(refs, plan):
        return sum(1 for p, r in refs if p is not plan and r() is not None)

    def gather(plan, shards):
        bwd = torch._C._current_graph_task_id() != -1
        rec["overlap_recompute" if bwd else "overlap_fwd"] += \
            others(gathered, plan)
        rec["grads_alive"] += others(whole, plan)
        out = gather0(plan, shards)
        gathered[:] = [(p, r) for p, r in gathered if r() is not None]
        gathered.extend((plan, weakref.ref(t.untyped_storage()))
                        for t in out)
        rec["gathers_recompute" if bwd else "gathers_fwd"] += 1
        return out

    def scatter(plan, grads):
        rec["grads_alive"] += others(whole, plan)
        rec["overlap_recompute"] += others(gathered, plan)
        whole[:] = [(p, r) for p, r in whole if r() is not None]
        whole.extend((plan, weakref.ref(g.untyped_storage()))
                     for g in grads)
        rec["scatters"] += 1
        out = fault(plan, grads) if fault is not None else None
        return scatter0(plan, grads) if out is None else out

    fsdp.gather_block, fsdp.scatter_block = gather, scatter
    try:
        yield rec
    finally:
        fsdp.gather_block, fsdp.scatter_block = gather0, scatter0
        rec["alive_after"] = sum(r() is not None for _, r in gathered + whole)


def _fsdp_step(inp, arch, shape, steps, fault=None):
    """``steps`` mesh steps of ``arch``'s smoke config on ``shape`` data
    / model from zero moments (:func:`_run_mesh_step`) under
    :func:`watch_blocks`, with the shapes of the block gradients the step
    hands AdamW (``grad_shapes``)."""
    from repro_torch.training import optimizer as opt

    acfg = opt.AdamWConfig(lr=1e-3, warmup=1, total_steps=10)
    norm0, shapes = opt.sharded_global_norm, {}

    def norm(grads, split, mesh):
        shapes.update({n: tuple(g.shape) for n, g in grads.items()
                       if n.startswith("blocks.")})
        return norm0(grads, split, mesh)

    rec = {}
    opt.sharded_global_norm = norm
    try:
        with watch_blocks(rec, fault):
            _, _, out = _run_mesh_step(shape, ("data", "model"), acfg,
                                       inp[f"tokens{shape[0]}"], steps,
                                       arch=arch)
    finally:
        opt.sharded_global_norm = norm0
    out.update(watch=rec, grad_shapes=shapes)
    return out


def _check_fsdp(name):
    def check(rank, inp, work):
        out = _fsdp_step(inp, *FSDP_CASES[name])
        if rank:
            del out["params"]
        return out
    arch, shape, steps = FSDP_CASES[name]
    check.__doc__ = (f"{arch}'s smoke config, {steps} steps on {shape} "
                     "data/model from zero moments, its gathers watched.")
    return check


def _check_fault_unreduced(rank, inp, work):
    """A planted fault: one step of qwen2.5-14b on (8, 1) with the second
    block's gradient cut to the rank's shard without the sum over
    data."""
    seen = []

    def fault(plan, grads):
        if plan not in seen:
            seen.append(plan)
        if plan is not seen[-1] or len(seen) < 2:
            return None
        ax = plan.axes[0]
        r = torch.distributed.get_rank(ax.group)
        return [g.chunk(ax.size, d)[r].contiguous() if d is not None else g
                for g, d in zip(grads, ax.dims)]

    out = _fsdp_step(inp, "qwen2.5-14b", (8, 1), 1, fault)
    if rank:
        del out["params"]
    return out


def _check_fault_pod_scale(rank, inp, work):
    """A planted fault: the pod step with ``pod_compressed_mean``'s scale
    taken over the rank's shard only (its max not over data and model)."""
    from repro_torch.training import optimizer as opt

    mean0 = opt.pod_compressed_mean

    def mean(grads, ef, axis="pod", mesh=None, split=None):
        return mean0(grads, ef, axis, mesh)

    opt.pod_compressed_mean = mean
    try:
        return _check_pod_step(rank, inp, work)
    finally:
        opt.pod_compressed_mean = mean0


def _check_fsdp_gather(rank, inp, work):
    """``fsdp.gather_block`` and ``fsdp.scatter_block`` of a block of
    four parameters on a (2, 2, 2) pod/data/model mesh: ``a`` (8, 3)
    split over (pod, data) on dim 0, ``b`` (10, 4) bf16 over model on dim
    0 (left alone) and over data on dim 1, ``c`` (3,) unsplit, ``d`` (6,
    2) over pod on dim 0.  Each rank's gather of its shards of the whole
    tensors and its scatter of gradients that are those times the rank's
    global rank plus one."""
    from torch import nn

    from repro_torch.distributed import fsdp
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    specs = {"a": (("pod", "data"), None), "b": ("model", "data"),
             "c": (None,), "d": ("pod", None)}
    full = {"a": torch.arange(24.).reshape(8, 3),
            "b": (torch.arange(40.) % 4).reshape(10, 4).to(torch.bfloat16),
            "c": torch.arange(3.), "d": torch.arange(12.).reshape(6, 2)}
    block = nn.Module()
    for n, t in full.items():
        block.register_parameter(n, nn.Parameter(
            shd.local_slice(t, mesh, specs[n]).clone()))
    plan = fsdp._plan(block, "", specs, mesh)
    shards = [getattr(block, leaf) for _, leaf in plan.leaves]
    got = fsdp.gather_block(plan, [s.detach() for s in shards])
    r = torch.distributed.get_rank()
    grads = [g * (r + 1) for g in got]
    back = fsdp.scatter_block(plan, grads)
    return {"leaves": [leaf for _, leaf in plan.leaves],
            "axes": [(a.name, a.dims) for a in plan.axes],
            "coord": mesh.get_coordinate(),
            "gathered": [g.float().numpy() for g in got],
            "scattered": [g.float().numpy() for g in back],
            "dtypes": [str(g.dtype) for g in back]}


DIST_CHECKS = {
    "mesh_step": _check_mesh_step, "moe_step": _check_moe_step,
    "pod_step": _check_pod_step,
    "reshard": _check_reshard, "jax_checkpoint": _check_jax_checkpoint,
    "flash_decode": _check_flash_decode, "decode_step": _check_decode_step,
    "tp_gemma3": _check_tp_gemma3, "tp_decode": _check_tp_decode,
    "gpipe": _check_gpipe, "pod_mean": _check_pod_mean,
    "launch_train": _check_launch_train,
    # tests/test_torch_tp_recurrent.py's group
    "tp_hymba": _check_tp_hymba, "tp_xlstm": _check_tp_xlstm,
    "tp_recurrent_decode": _check_tp_recurrent_decode,
    # tests/test_torch_fsdp.py's group
    **{k: _check_fsdp(k) for k in FSDP_CASES},
    "fsdp_pod": _check_pod_step, "fsdp_gather": _check_fsdp_gather,
    "fault_unreduced": _check_fault_unreduced,
    "fault_pod_scale": _check_fault_pod_scale,
}
# the checks of each group (``dist_main``'s ``group``): one a test file,
# each file under tests/test_oracle.py's 16 tests (ROADMAP "Time budget")
DIST_GROUPS = {
    "mesh": ("mesh_step", "moe_step", "pod_step", "reshard",
             "jax_checkpoint", "flash_decode", "decode_step", "tp_gemma3",
             "tp_decode", "gpipe", "pod_mean", "launch_train"),
    "tp_recurrent": ("tp_hymba", "tp_xlstm", "tp_recurrent_decode"),
    "fsdp": tuple(FSDP_CASES) + ("fsdp_pod", "fsdp_gather",
                                 "fault_unreduced", "fault_pod_scale"),
}


def dist_worker(rank: int, work: str, group: str = "mesh") -> None:
    """One rank: every check of ``DIST_GROUPS[group]``, each one's seconds,
    saved to ``<work>/rank<r>.pt``; a failure writes
    ``<work>/rank<r>.err``."""
    import datetime
    import time
    import traceback

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{work}/store", rank=rank,
            world_size=DIST_WORLD,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        inp = torch.load(f"{work}/inputs.pt", weights_only=False)
        out, secs = {}, {}
        for name in DIST_GROUPS[group]:
            t0 = time.perf_counter()
            out[name] = DIST_CHECKS[name](rank, inp, work)
            secs[name] = time.perf_counter() - t0
        out["seconds"] = secs
        torch.save(out, f"{work}/rank{rank}.pt")
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(f"{work}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def dist_main(work: str, group: str = "mesh") -> None:
    """Fork DIST_WORLD ranks of :func:`dist_worker` running ``group``'s
    checks (the port imported once, before the fork) and wait; when one
    fails, stop the others and exit non-zero with its traceback."""
    import multiprocessing as mp
    import sys
    import time

    # everything the ranks import, once, before the fork (torch._dynamo
    # comes with the first torch.utils.checkpoint call)
    import torch._dynamo  # noqa: F401
    import torch.distributed.device_mesh  # noqa: F401
    import torch.distributed.tensor  # noqa: F401

    import repro_torch.distributed.pipeline_parallel  # noqa: F401
    import repro_torch.launch.train  # noqa: F401

    ctx = mp.get_context("fork")
    procs = [ctx.Process(target=dist_worker, args=(r, work, group))
             for r in range(DIST_WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DIST_TIMEOUT_S
    while any(p.is_alive() for p in procs):
        failed = [r for r, p in enumerate(procs)
                  if p.exitcode not in (None, 0)]
        if failed or time.monotonic() > deadline:
            for p in procs:
                p.kill()
            errs = [open(f"{work}/rank{r}.err").read() for r in failed]
            sys.exit(f"ranks {failed} failed (or the run timed out):\n"
                     + "\n".join(errs))
        time.sleep(0.05)
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        sys.exit(f"ranks {bad} failed:\n" + "\n".join(
            open(f"{work}/rank{r}.err").read() for r in bad))
