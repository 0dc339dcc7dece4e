"""Storage-device models and the Little's-law throughput math.

Port of ``repro.core.ssd``: the ``SSDSpec`` table (paper Table III), block
striping over an array of devices, the host-side Little's-law service time
(``ArrayOfSSDs.service_time``, which the paged-KV manager charges) and the
per-device service-time model.
``FaultModel`` is carried as configuration only: its enabled path (command
status by counter hash) waits for a later slice, and ``BamArray.build``
refuses an enabled model.
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


def device_of_block(keys: torch.Tensor, n_devices: int,
                    stripe_blocks: int = 1) -> torch.Tensor:
    """Stripe block keys across the devices, round-robin by stripe; invalid
    keys (< 0) map to device 0 so they can be masked downstream.  The same
    function routes SQ commands and charges per-device service time."""
    dev = torch.remainder(torch.div(keys, stripe_blocks, rounding_mode="floor"),
                          n_devices).to(torch.int32)
    return torch.where(keys >= 0, dev, 0).to(torch.int32)


def device_histogram(keys: torch.Tensor, n_devices: int,
                     mask: torch.Tensor | None = None,
                     stripe_blocks: int = 1) -> torch.Tensor:
    """Count valid block keys per device: (n_devices,) int32.  A bincount
    in place of the reference's one-hot sum: integer sums are order-free."""
    valid = keys >= 0
    if mask is not None:
        valid = valid & mask
    dev = device_of_block(keys, n_devices, stripe_blocks)
    return _bincount_masked(dev, valid, n_devices)


def _bincount_masked(idx: torch.Tensor, mask: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Per-bin count of ``mask`` lanes, without a host sync: masked lanes
    add 0 to bin 0."""
    out = torch.zeros((n,), dtype=torch.int32, device=idx.device)
    return out.index_add_(0, torch.where(mask, idx, 0).to(torch.int64),
                          mask.to(torch.int32))


def sustained_rate(concurrent: float, latency_s: float,
                   peak_iops: float) -> float:
    """Delivery rate for X concurrently serviceable requests: X / (L + X/T),
    which approaches ``peak_iops`` when X >> T * L (paper §II-C)."""
    if concurrent <= 0:
        return 0.0
    return concurrent / (latency_s + concurrent / peak_iops)


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Deterministic fault injection (configuration only in this slice).

    The default model is disabled; ``BamArray.build`` raises
    ``NotImplementedError`` for an enabled one.
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
