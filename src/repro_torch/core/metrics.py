"""I/O accounting: hit rates, queue depths and I/O amplification.

Port of ``repro.core.metrics``.  The counters are float64 tensors on the
array's device: one BFS/CC round at the deployment's size counts 2^28
requests, and a float32 counter stops being exact above 2^24.  float64 is
what the reference gives under x64.  The high-watermarks stay int32.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils import resolve_device

F64 = torch.float64


@dataclasses.dataclass
class IOMetrics:
    requests: torch.Tensor          # element-level requests issued by compute
    bytes_requested: torch.Tensor   # bytes the compute consumed (useful bytes)
    hits: torch.Tensor              # cache-line hits (post-coalescing)
    misses: torch.Tensor            # cache-line misses -> storage reads
    bytes_from_storage: torch.Tensor
    write_ops: torch.Tensor
    bytes_to_storage: torch.Tensor
    doorbells: torch.Tensor         # batched ring-tail updates
    dropped: torch.Tensor           # commands rejected by ring back-pressure
    sim_time_s: torch.Tensor        # simulated device service time
    read_time_s: torch.Tensor       # read-direction share
    write_time_s: torch.Tensor      # write-direction share
    max_queue_depth: torch.Tensor   # high-watermark of in-flight requests
    prefetch_issued: torch.Tensor   # cache lines fetched speculatively
    prefetch_hits: torch.Tensor     # demand line-hits served by a prefetch
    tokens_submitted: torch.Tensor  # IOTokens issued
    tokens_waited: torch.Tensor     # IOTokens completed by wait()
    tokens_in_flight: torch.Tensor  # running outstanding-token count
    cross_op_coalesced: torch.Tensor  # line requests merged with a pending fetch
    max_tokens_in_flight: torch.Tensor  # high-watermark of the token window
    transient_errors: torch.Tensor  # fault accounting (zero: faults disabled)
    retries: torch.Tensor
    failed_commands: torch.Tensor
    degraded_reads: torch.Tensor
    dev_reads: torch.Tensor         # (n_devices,) lines fetched per device
    dev_writes: torch.Tensor        # (n_devices,) lines written back per device
    dev_bytes: torch.Tensor         # (n_devices,) bytes moved per device
    dev_time_s: torch.Tensor        # (n_devices,) per-device busy time
    dev_errors: torch.Tensor        # (n_devices,) failed commands per device
    dev_max_depth: torch.Tensor     # (n_devices,) int32 in-flight watermark

    @staticmethod
    def zeros(n_devices: int = 1, device=None) -> "IOMetrics":
        """Zero counters on ``device`` (CUDA unless the caller asks for
        another)."""
        device = resolve_device(device)

        def f():
            return torch.zeros((), dtype=F64, device=device)

        def i():
            return torch.zeros((), dtype=torch.int32, device=device)

        def fd():
            return torch.zeros((n_devices,), dtype=F64, device=device)

        return IOMetrics(
            requests=f(), bytes_requested=f(), hits=f(), misses=f(),
            bytes_from_storage=f(), write_ops=f(), bytes_to_storage=f(),
            doorbells=f(), dropped=f(),
            sim_time_s=f(), read_time_s=f(), write_time_s=f(),
            max_queue_depth=i(),
            prefetch_issued=f(), prefetch_hits=f(),
            tokens_submitted=f(), tokens_waited=f(), tokens_in_flight=f(),
            cross_op_coalesced=f(), max_tokens_in_flight=i(),
            transient_errors=f(), retries=f(), failed_commands=f(),
            degraded_reads=f(),
            dev_reads=fd(), dev_writes=fd(), dev_bytes=fd(),
            dev_time_s=fd(), dev_errors=fd(),
            dev_max_depth=torch.zeros((n_devices,), dtype=torch.int32,
                                      device=device),
        )

    def clone(self) -> "IOMetrics":
        """A copy whose tensors share nothing with this one."""
        return IOMetrics(**{f.name: getattr(self, f.name).clone()
                            for f in dataclasses.fields(self)})

    @property
    def n_devices(self) -> int:
        return int(self.dev_reads.shape[0])

    # Derived quantities (host-side reads) --------------------------------
    def amplification(self) -> float:
        br = float(self.bytes_requested)
        return float(self.bytes_from_storage) / br if br > 0 else 0.0

    def hit_rate(self) -> float:
        tot = float(self.hits) + float(self.misses)
        return float(self.hits) / tot if tot > 0 else 0.0

    def read_iops(self) -> float:
        fetched = float(self.misses) + float(self.prefetch_issued)
        t = float(self.read_time_s)
        if t <= 0.0:
            t = float(self.sim_time_s)
        return fetched / t if t > 0 else 0.0

    def prefetch_accuracy(self) -> float:
        issued = float(self.prefetch_issued)
        return float(self.prefetch_hits) / issued if issued > 0 else 0.0

    def straggler_gap(self) -> float:
        t = self.dev_time_s.detach().cpu()
        mean = float(t.mean())
        return float(t.max()) / mean if mean > 0 else 0.0

    def summary(self) -> dict:
        def vec(x):
            return [float(v) for v in x.detach().cpu().tolist()]

        return {
            "requests": float(self.requests),
            "bytes_requested": float(self.bytes_requested),
            "hits": float(self.hits),
            "misses": float(self.misses),
            "hit_rate": self.hit_rate(),
            "bytes_from_storage": float(self.bytes_from_storage),
            "write_ops": float(self.write_ops),
            "bytes_to_storage": float(self.bytes_to_storage),
            "amplification": self.amplification(),
            "doorbells": float(self.doorbells),
            "dropped": float(self.dropped),
            "sim_time_s": float(self.sim_time_s),
            "read_time_s": float(self.read_time_s),
            "write_time_s": float(self.write_time_s),
            "read_iops": self.read_iops(),
            "max_queue_depth": int(self.max_queue_depth),
            "prefetch_issued": float(self.prefetch_issued),
            "prefetch_hits": float(self.prefetch_hits),
            "prefetch_accuracy": self.prefetch_accuracy(),
            "tokens_submitted": float(self.tokens_submitted),
            "tokens_waited": float(self.tokens_waited),
            "tokens_in_flight": float(self.tokens_in_flight),
            "cross_op_coalesced": float(self.cross_op_coalesced),
            "max_tokens_in_flight": int(self.max_tokens_in_flight),
            "transient_errors": float(self.transient_errors),
            "retries": float(self.retries),
            "failed_commands": float(self.failed_commands),
            "degraded_reads": float(self.degraded_reads),
            "n_devices": self.n_devices,
            "dev_reads": vec(self.dev_reads),
            "dev_writes": vec(self.dev_writes),
            "dev_bytes": vec(self.dev_bytes),
            "dev_time_s": vec(self.dev_time_s),
            "dev_errors": vec(self.dev_errors),
            "dev_max_depth": [int(v) for v in
                              self.dev_max_depth.detach().cpu().tolist()],
            "straggler_gap": self.straggler_gap(),
        }


# Watermark (high-water) fields combine by max; everything else is an
# additive counter.
WATERMARK_FIELDS = ("max_queue_depth", "dev_max_depth",
                    "max_tokens_in_flight")
ADDITIVE_FIELDS = tuple(
    f.name for f in dataclasses.fields(IOMetrics)
    if f.name not in WATERMARK_FIELDS)


def metrics_delta(new: IOMetrics, old: IOMetrics) -> IOMetrics:
    """Per-op increment: additive fields subtract, watermarks carry ``new``."""
    kw = {f: getattr(new, f) - getattr(old, f) for f in ADDITIVE_FIELDS}
    kw.update({f: getattr(new, f) for f in WATERMARK_FIELDS})
    return IOMetrics(**kw)


def metrics_accumulate(acc: IOMetrics, delta: IOMetrics) -> IOMetrics:
    """Fold a :func:`metrics_delta` into an accumulator: additive fields
    sum, watermarks take the max.  A new object; neither argument
    changes (the runtime's ``absorb`` folds deltas with it)."""
    kw = {f: getattr(acc, f) + getattr(delta, f) for f in ADDITIVE_FIELDS}
    kw.update({f: torch.maximum(getattr(acc, f), getattr(delta, f))
               for f in WATERMARK_FIELDS})
    return IOMetrics(**kw)


def metrics_sum(parts) -> IOMetrics:
    """Combine per-tenant metrics into the global view (sum / max)."""
    parts = list(parts)
    acc = parts[0]
    for p in parts[1:]:
        acc = metrics_accumulate(acc, p)
    return acc


def recheck_token_watermark(mt: IOMetrics) -> None:
    """Re-arm ``max_tokens_in_flight`` against the current window, in place
    (the reference returns a rebuilt ``IOMetrics``)."""
    mt.max_tokens_in_flight = torch.maximum(
        mt.max_tokens_in_flight, mt.tokens_in_flight.to(torch.int32))
