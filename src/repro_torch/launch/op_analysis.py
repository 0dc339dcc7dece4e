"""Per-device cost of an eager PyTorch program, from one dispatch walk.

The counterpart of ``repro.launch.hlo_analysis``, with the same job: the
three roofline inputs of one device's step, and here also the bytes it
holds at once.  One ``TorchDispatchMode`` (:class:`OpWalk`) sees every aten
op the step runs, autograd's backward and a DTensor's local ops included,
on real tensors or on the ``meta`` device (shapes only), and counts:

  * dot FLOPs         ``torch.utils.flop_counter``'s formulas (``mm``,
                      ``bmm``, ``addmm``, convolution, SDPA): the
                      reference's MXU term
  * memory bytes      operand plus result bytes of every aten op.  Eager
                      PyTorch fuses nothing, so every op reads its operands
                      from memory and writes its results back: each op is a
                      round trip, where the reference counts the top-level
                      instructions of the post-fusion HLO.  As there, a
                      gather counts its result twice, a scatter its update
                      three times; a view, an allocation without a fill and
                      a collective's wait count nothing, and ``copy_``
                      reads only its source
  * collective bytes  by kind (``c10d`` and ``c10d_functional`` ops), the
                      result bytes, ring-factor-adjusted as the reference's
                      ``_COLL_FACTOR``; a collective over a group of one
                      rank moves nothing and counts nothing
  * live bytes        the storages the walk's ops allocate and that are
                      alive at once, each rounded up to the CUDA caching
                      allocator's 512-byte block: ``peak_bytes`` is what
                      ``torch.cuda.max_memory_allocated`` would add over
                      what existed before the walk.  A function wrapped by
                      :meth:`OpWalk.stand_in` (a kernel's plain version
                      run in the kernel's place) has its temporaries
                      booked apart: ``kernel_peak_bytes`` leaves out what
                      such a call holds beyond its outputs, and
                      ``stand_in_bytes`` is the most it held at once.  Its
                      ops' cost is also kept apart (``stand_in_cost``), and
                      ``kernel_mem_bytes`` counts such a call as one round
                      trip (its tensor arguments read, its outputs
                      written), as a kernel makes it

Loops need no trip counts: the walk sees each iteration's ops.  Not ported
on purpose: ``hlo_analysis``'s HLO text parser, its custom-call targets and
its branch helpers, which serve ``tools/bamverify``'s audits of compiled
JAX programs and have no eager counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["Cost", "OpWalk"]

# effective wire bytes per device ~ factor x result bytes (ring algorithms)
_COLL_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

_COLL_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "broadcast_": "collective-permute", "broadcast": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLL_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

# ops that move no bytes: fresh storage without a fill, aliases, waits
_ZERO_COST = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "detach", "alias", "lift_fresh",
              "_unsafe_view", "wait_tensor", "_wrap_tensor_autograd",
              "record_stream", "set_", "resize_"}
# reads a window of an operand: result bytes twice (read + write)
_GATHERS = {"index", "index_select", "gather", "embedding", "take"}
# writes a window into an operand: the update three times
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter",
             "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
             "scatter_reduce_", "index_add", "index_add_", "index_copy",
             "index_copy_", "slice_scatter", "select_scatter",
             "masked_scatter", "masked_scatter_"}

ALLOC_BLOCK = 512     # the CUDA caching allocator's smallest block, bytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    mem_bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __iadd__(self, other: "Cost"):
        self.flops += other.flops
        self.mem_bytes += other.mem_bytes
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + v
        return self

    def scaled(self, t: float) -> "Cost":
        return Cost(self.flops * t, self.mem_bytes * t,
                    {k: v * t for k, v in self.coll_bytes.items()})

    @property
    def total_coll_bytes(self) -> float:
        return sum(_COLL_FACTOR.get(k, 1.0) * v
                   for k, v in self.coll_bytes.items())


def _group_size(func, args) -> int:
    """The ranks of a collective's process group (2 when it cannot be
    told: counted as moving bytes)."""
    import torch.distributed as dist

    for a in args:
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
        if isinstance(a, str) and func.namespace != "c10d":
            try:
                return dist.distributed_c10d._resolve_process_group(
                    a).size()
            except (KeyError, ValueError, RuntimeError):
                continue
    return 2


def _block(n: int) -> int:
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


class OpWalk(TorchDispatchMode):
    """Counts :class:`Cost` and live bytes over the ops run under it.

    ``cost`` accumulates; ``n_ops`` counts aten ops; ``live_bytes`` is the
    size of the storages allocated under the walk and still alive, and
    ``peak_bytes`` its largest value.  A storage that existed before the
    walk (a parameter, an argument, an in-place op's operand) is never
    counted.  ``kernel_peak_bytes`` is the largest live size without the
    temporaries of calls wrapped by :meth:`stand_in`, ``stand_in_bytes``
    the most of those alive at once."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary

        self._flops = flop_registry
        self._seen = WeakIdKeyDictionary()
        self.cost = Cost()
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.kernel_peak_bytes = 0
        self.stand_in_bytes = 0
        self._transient = 0         # live bytes allocated inside stand-ins
        self._marked = set()        # their storages' tokens
        self._depth = 0
        self._n_storages = 0
        self.stand_in_cost = Cost()
        self.stand_in_io_bytes = 0.0
        self._fake_on_entry = None

    def __enter__(self):
        from torch._guards import active_fake_mode

        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def stand_in(self, fn):
        """``fn`` wrapped so that what it allocates, its outputs excepted,
        is booked as a stand-in's temporaries (see the class)."""
        def wrapped(*args, **kwargs):
            outer = self._depth == 0
            before = self.cost.scaled(1.0)
            self._depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self._depth -= 1
            if outer:
                self.stand_in_cost += Cost(
                    self.cost.flops - before.flops,
                    self.cost.mem_bytes - before.mem_bytes)
                self.stand_in_io_bytes += float(sum(
                    _nbytes(t) for t in _tensors((args, kwargs, out))))
            for t in _tensors(out):
                n, tok = self._seen.get(t.untyped_storage(), (0, None))
                if tok in self._marked:
                    self._marked.discard(tok)
                    self._transient -= n
            self.kernel_peak_bytes = max(self.kernel_peak_bytes,
                                         self.live_bytes - self._transient)
            return out
        return wrapped

    @property
    def kernel_mem_bytes(self) -> float:
        """``cost.mem_bytes`` with each stand-in call one round trip."""
        return (self.cost.mem_bytes - self.stand_in_cost.mem_bytes
                + self.stand_in_io_bytes)

    def _free(self, n: int, tok: int) -> None:
        self.live_bytes -= n
        if tok in self._marked:
            self._marked.discard(tok)
            self._transient -= n

    def _track(self, out, inputs) -> None:
        import weakref

        old = {id(t.untyped_storage()) for t in inputs}
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = 0 if id(st) in old else _block(st.nbytes())
            self._n_storages += 1
            tok = self._n_storages
            self._seen[st] = (n, tok)
            if n:
                self.live_bytes += n
                if self._depth:
                    self._marked.add(tok)
                    self._transient += n
                weakref.finalize(st, self._free, n, tok)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self.kernel_peak_bytes = max(self.kernel_peak_bytes,
                                     self.live_bytes - self._transient)
        self.stand_in_bytes = max(self.stand_in_bytes, self._transient)

    def _op_cost(self, func, args, kwargs, out, inputs) -> Cost:
        name = func._overloadpacket.__name__
        if func.namespace in _COLL_NAMESPACES:
            kind = _COLL_KIND.get(name)
            if kind is None or _group_size(func, args) < 2:
                return Cost()
            b = float(sum(_nbytes(t) for t in _tensors(out)))
            return Cost(mem_bytes=b, coll_bytes={kind: b})
        c = Cost()
        pkt = func._overloadpacket
        if pkt in self._flops:
            c.flops = float(self._flops[pkt](*args, **(kwargs or {}),
                                             out_val=out))
        if func.is_view or name in _ZERO_COST:
            return c
        outs = _tensors(out)
        if name in _GATHERS:
            c.mem_bytes = 2.0 * sum(_nbytes(t) for t in outs)
        elif name in _SCATTERS:
            upd = [_nbytes(t) for t in inputs[1:]]
            c.mem_bytes = 3.0 * max(upd) if upd else 0.0
        elif name == "copy_":
            c.mem_bytes = float(sum(_nbytes(t) for t in inputs))
        else:
            c.mem_bytes = float(sum(_nbytes(t) for t in inputs)
                                + sum(_nbytes(t) for t in outs))
        return c

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor

        # let a DTensor run its local ops, which come back through here
        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        # ops DTensor runs on fake tensors to propagate its shardings are
        # not the step's
        if active_fake_mode() is not self._fake_on_entry:
            return out
        inputs = _tensors((args, kwargs))
        self.n_ops += 1
        self.cost += self._op_cost(func, args, kwargs, out, inputs)
        self._track(out, inputs)
        return out

