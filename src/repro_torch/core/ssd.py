"""Storage-device models and the Little's-law throughput math.

Port of ``repro.core.ssd``: the ``SSDSpec`` table (paper Table III), block
striping over an array of devices (remapped around hard-failed ones), the
host-side Little's-law service time (``ArrayOfSSDs.service_time``, which
the paged-KV manager charges), the §II-C sizing helpers
(``required_queue_depth``, ``target_iops_for_link``,
``min_ssds_for_target``) and the device cost model
(``ArrayOfSSDs.cost_usd``), the per-device service-time model, and the
``FaultModel``: a command's retry loop resolved in closed form from a
counter hash of ``(device, ticket, attempt)``.

The hash is the reference's uint32 arithmetic.  Torch has no uint32
multiply on CUDA, so values are held in int64 below 2^32 and every product
is taken modulo 2^32 from 16-bit halves of the constant (:func:`mul_u32`),
which never leaves int64's range.
"""
from __future__ import annotations

import dataclasses
import math

import torch

PCIE_GEN4_X16_BW = 26.3e9  # bytes/s, measured (paper §II-A)
PCIE_GEN4_X4_BW = 6.575e9  # bytes/s, x16/4


@dataclasses.dataclass(frozen=True)
class SSDSpec:
    """One storage technology row of Table III."""

    name: str
    read_iops_512: float
    read_iops_4k: float
    write_iops_512: float
    write_iops_4k: float
    latency_s: float
    dwpd: float
    dollars_per_gb: float
    link_bw: float = PCIE_GEN4_X4_BW

    def read_iops(self, block_bytes: int) -> float:
        return _interp_iops(block_bytes, self.read_iops_512, self.read_iops_4k)

    def write_iops(self, block_bytes: int) -> float:
        return _interp_iops(block_bytes, self.write_iops_512,
                            self.write_iops_4k)


def _interp_iops(block_bytes: int, iops_512: float, iops_4k: float) -> float:
    if block_bytes <= 512:
        return iops_512
    if block_bytes >= 4096:
        return iops_4k * 4096.0 / block_bytes
    t = (math.log2(block_bytes) - 9.0) / 3.0
    return iops_512 * (iops_4k / iops_512) ** t


DRAM_DIMM = SSDSpec(
    name="dram-dimm",
    read_iops_512=10e6, read_iops_4k=10e6,
    write_iops_512=10e6, write_iops_4k=10e6,
    latency_s=0.1e-6, dwpd=1000.0, dollars_per_gb=11.13,
    link_bw=PCIE_GEN4_X16_BW,
)
INTEL_OPTANE_P5800X = SSDSpec(
    name="intel-optane-p5800x",
    read_iops_512=5.1e6, read_iops_4k=1.5e6,
    write_iops_512=1.0e6, write_iops_4k=1.5e6,
    latency_s=11e-6, dwpd=100.0, dollars_per_gb=2.54,
)
SAMSUNG_ZNAND_P1735 = SSDSpec(
    name="samsung-znand-p1735",
    read_iops_512=1.1e6, read_iops_4k=1.6e6,
    write_iops_512=351e3, write_iops_4k=351e3,
    latency_s=25e-6, dwpd=3.0, dollars_per_gb=2.56,
)
SAMSUNG_980PRO = SSDSpec(
    name="samsung-980pro",
    read_iops_512=750e3, read_iops_4k=750e3,
    write_iops_512=172e3, write_iops_4k=172e3,
    latency_s=324e-6, dwpd=0.3, dollars_per_gb=0.51,
)

SSD_PRESETS: dict[str, SSDSpec] = {
    s.name: s
    for s in (DRAM_DIMM, INTEL_OPTANE_P5800X, SAMSUNG_ZNAND_P1735,
              SAMSUNG_980PRO)
}


def _alive_devices(n_devices: int, failed_devices) -> tuple:
    """Surviving device ids, in order, after masking out hard failures."""
    failed = frozenset(int(d) for d in failed_devices)
    bad = [d for d in failed if d < 0 or d >= n_devices]
    if bad:
        raise ValueError(f"failed_devices {sorted(bad)} out of range for "
                         f"n_devices={n_devices}")
    alive = tuple(d for d in range(n_devices) if d not in failed)
    if not alive:
        raise ValueError("all devices marked failed: nothing left to route to")
    return alive


def device_of_block(keys: torch.Tensor, n_devices: int,
                    stripe_blocks: int = 1,
                    failed_devices=()) -> torch.Tensor:
    """Stripe block keys across the devices, round-robin by stripe; invalid
    keys (< 0) map to device 0 so they can be masked downstream.  Blocks
    whose home device is in ``failed_devices`` remap to
    ``alive[(key // stripe) % n_alive]``.  The same function routes SQ
    commands and charges per-device service time."""
    stripe = torch.div(keys, stripe_blocks, rounding_mode="floor")
    dev = torch.remainder(stripe, n_devices).to(torch.int32)
    if failed_devices:
        alive = _alive_devices(n_devices, failed_devices)
        r = torch.remainder(stripe, len(alive))
        remap = torch.zeros_like(dev)
        for i, a in enumerate(alive):       # a handful of devices
            remap = torch.where(r == i, a, remap)
        dead = torch.zeros_like(dev, dtype=torch.bool)
        for d in failed_devices:
            dead = dead | (dev == int(d))
        dev = torch.where(dead, remap, dev)
    return torch.where(keys >= 0, dev, 0).to(torch.int32)


def device_histogram(keys: torch.Tensor, n_devices: int,
                     mask: torch.Tensor | None = None,
                     stripe_blocks: int = 1,
                     failed_devices=()) -> torch.Tensor:
    """Count valid block keys per device: (n_devices,) int32.  A bincount
    in place of the reference's one-hot sum: integer sums are order-free."""
    valid = keys >= 0
    if mask is not None:
        valid = valid & mask
    dev = device_of_block(keys, n_devices, stripe_blocks, failed_devices)
    return _bincount_masked(dev, valid, n_devices)


def _bincount_masked(idx: torch.Tensor, mask: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Per-bin count of ``mask`` lanes, without a host sync: masked lanes
    add 0 to bin 0."""
    out = torch.zeros((n,), dtype=torch.int32, device=idx.device)
    return out.index_add_(0, torch.where(mask, idx, 0).to(torch.int64),
                          mask.to(torch.int32))


def required_queue_depth(target_iops: float, latency_s: float) -> int:
    """Q_d = T x L (paper §II-C): the requests that must be in flight to
    deliver ``target_iops`` at ``latency_s``."""
    return int(math.ceil(target_iops * latency_s))


def target_iops_for_link(link_bw: float, block_bytes: int) -> float:
    """T such that T x block = the link's bandwidth (26.3 GB/s over 512 B
    blocks: 51M/s)."""
    return link_bw / block_bytes


def min_ssds_for_target(spec: SSDSpec, block_bytes: int, target_iops: float,
                        write: bool = False) -> int:
    """Devices of ``spec`` needed to reach ``target_iops``, each capped by
    its own link."""
    per_dev = spec.write_iops(block_bytes) if write \
        else spec.read_iops(block_bytes)
    per_dev = min(per_dev, spec.link_bw / block_bytes)
    return int(math.ceil(target_iops / per_dev))


def sustained_rate(concurrent: float, latency_s: float,
                   peak_iops: float) -> float:
    """Delivery rate for X concurrently serviceable requests: X / (L + X/T),
    which approaches ``peak_iops`` when X >> T * L (paper §II-C)."""
    if concurrent <= 0:
        return 0.0
    return concurrent / (latency_s + concurrent / peak_iops)


_FAULT_PROB_BITS = 24   # error rates quantize to multiples of 2^-24 (exact)
_U32 = 0xFFFFFFFF


def mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for int64 ``h`` in [0, 2^32) and a constant
    ``c`` < 2^32: the constant's two 16-bit halves keep every partial
    product below 2^48, so nothing wraps in int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul_u32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Deterministic fault injection for an :class:`ArrayOfSSDs`.

    ``transient_error_rate`` is a command attempt's failure probability,
    quantized to multiples of 2^-24; ``tail_latency_mult`` the service time
    charged for each retry; ``failed_devices`` hard-failed device ids (their
    blocks remap to the survivors, and a command that reaches one errors at
    once); ``retry_budget`` the re-issues a command gets before it retires
    with an error; ``seed`` the hash salt.  The default model is disabled
    and leaves every path as it is without faults.
    """

    transient_error_rate: float = 0.0
    tail_latency_mult: float = 1.0
    failed_devices: tuple = ()
    retry_budget: int = 3
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.transient_error_rate <= 1.0:
            raise ValueError("transient_error_rate must be in [0, 1]")
        if self.tail_latency_mult < 1.0:
            raise ValueError("tail_latency_mult must be >= 1")
        if self.retry_budget < 0:
            raise ValueError("retry_budget must be >= 0")
        object.__setattr__(
            self, "failed_devices",
            tuple(sorted({int(d) for d in self.failed_devices})))

    @property
    def threshold(self) -> int:
        return int(round(self.transient_error_rate * (1 << 24)))

    @property
    def enabled(self) -> bool:
        return self.threshold > 0 or bool(self.failed_devices)

    def attempt_failed(self, dev: torch.Tensor, ticket: torch.Tensor,
                       attempt: int) -> torch.Tensor:
        """Did attempt ``attempt`` of command ``ticket`` on ``dev`` fail?
        The counters are hashed with the seed as uint32 and the low 24 bits
        compared with the quantized rate, as in the reference."""
        d = dev.to(torch.int64) & _U32
        t = ticket.to(torch.int64) & _U32
        h = (mul_u32(d, 0x9E3779B1) ^ mul_u32(t, 0x85EBCA77)
             ^ ((attempt * 0xC2B2AE3D) & _U32)
             ^ ((self.seed * 0x27D4EB2F) & _U32))
        h = _fmix32(h)
        return (h & ((1 << _FAULT_PROB_BITS) - 1)) < self.threshold

    def command_status(self, dev: torch.Tensor, ticket: torch.Tensor):
        """A command's bounded retry loop in closed form, elementwise over
        ``dev`` and ``ticket`` (broadcast together): ``(ok, retries,
        transient)``.  ``ok``: some attempt up to ``retry_budget`` succeeded
        on a live device; ``retries``: re-issues made (leading failed
        attempts, capped at the budget); ``transient``: failed attempts.
        Rows with ``ticket < 0`` carry no command and report ``(True, 0,
        0)``; a hard-failed device errors at once, with no retries."""
        d, t = torch.broadcast_tensors(dev, ticket)
        has_cmd = t >= 0
        transient = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
        if self.threshold == 0:
            all_failed = torch.zeros(t.shape, dtype=torch.bool,
                                     device=t.device)
        else:
            prefix = torch.ones(t.shape, dtype=torch.bool, device=t.device)
            for attempt in range(self.retry_budget + 1):
                prefix = prefix & self.attempt_failed(d, t, attempt)
                transient = transient + prefix.to(torch.int32)
            all_failed = prefix
        hard = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
        for fd in self.failed_devices:
            hard = hard | (d == int(fd))
        live = has_cmd & ~hard
        ok = ~has_cmd | (live & ~all_failed)
        retries = torch.where(
            live, torch.clamp(transient, max=self.retry_budget), 0)
        transient = torch.where(live, transient, 0)
        return ok, retries.to(torch.int32), transient.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class ArrayOfSSDs:
    """N identical devices behind one accelerator link."""

    spec: SSDSpec
    n_devices: int = 1
    accel_link_bw: float = PCIE_GEN4_X16_BW
    stripe_blocks: int = 1
    fault: FaultModel = FaultModel()

    def peak_read_iops(self, block_bytes: int) -> float:
        dev = self.n_devices * min(self.spec.read_iops(block_bytes),
                                   self.spec.link_bw / block_bytes)
        return min(dev, self.accel_link_bw / block_bytes)

    def peak_write_iops(self, block_bytes: int) -> float:
        dev = self.n_devices * min(self.spec.write_iops(block_bytes),
                                   self.spec.link_bw / block_bytes)
        return min(dev, self.accel_link_bw / block_bytes)

    def service_time(self, n_requests: int, block_bytes: int, *,
                     write: bool = False) -> float:
        """Simulated seconds to drain ``n_requests`` random accesses
        (host-side Python floats) at the X / (L + X/T) delivery rate, all
        requests in flight at once."""
        if n_requests <= 0:
            return 0.0
        peak = (self.peak_write_iops if write
                else self.peak_read_iops)(block_bytes)
        return n_requests / sustained_rate(float(n_requests),
                                           self.spec.latency_s, peak)

    def per_device_peak_iops(self, block_bytes: int, *,
                             write: bool = False) -> float:
        iops = (self.spec.write_iops if write else self.spec.read_iops)(
            block_bytes)
        return min(iops, self.spec.link_bw / block_bytes)

    def service_time_per_device(self, n_per_device: torch.Tensor,
                                block_bytes: int, *,
                                queue_depth_limit: int | None = None,
                                write: bool = False):
        """Wavefront drain time with per-device channels: each device drains
        its share at its own Little's-law rate, the slowest gates the batch,
        and the accelerator link is an aggregate floor.

        ``n_per_device`` is an (n_devices,) int tensor.  The arithmetic is
        float32, as in the reference's traced model, so a round's charge is
        the same number in both packages; callers accumulate it in float64.
        Returns ``(t_total, t_per_device)``.
        """
        n = n_per_device.to(torch.float32)

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=n.device)

        peak = f32(self.per_device_peak_iops(block_bytes, write=write))
        conc = n
        if queue_depth_limit is not None:
            conc = torch.minimum(conc, f32(float(queue_depth_limit)))
        rate = conc / (f32(self.spec.latency_s) + conc / peak)
        t_dev = torch.where(n > 0, n / torch.maximum(rate, f32(1e-30)),
                            torch.zeros_like(n))
        t_link = n.sum() * f32(float(block_bytes)) / f32(self.accel_link_bw)
        return torch.maximum(t_dev.max(), t_link), t_dev

    def cost_usd(self, capacity_gb: float) -> float:
        return capacity_gb * self.spec.dollars_per_gb
