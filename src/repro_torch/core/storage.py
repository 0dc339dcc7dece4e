"""Block-store backends for the BaM storage tier.

Port of ``repro.core.storage``:

* ``SimStorage``: the blocks live in host memory, pinned when the array
  runs on CUDA.  ``fetch_blocks`` copies the keys to the host, indexes the
  host tensor and copies the lines to the device without blocking; this
  takes the place of the reference's ``pure_callback``.  ``write_blocks``
  writes the host tensor in place of ``io_callback``.
* ``HBMStorage``: the blocks are a device tensor, written in place.

Both return zero lines for sentinel keys (< 0).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _blocks_of(flat: torch.Tensor, block_elems: int) -> torch.Tensor:
    pad = (-flat.shape[0]) % block_elems
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block_elems)


@dataclasses.dataclass
class SimStorage:
    """Host-resident block store (the 'SSD')."""

    data: torch.Tensor     # (num_blocks, block_elems) on the host
    device: torch.device   # where fetched lines are delivered

    @property
    def num_blocks(self) -> int:
        return self.data.shape[0]

    @property
    def block_elems(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    def fetch_blocks(self, keys: torch.Tensor) -> torch.Tensor:
        k = keys.to("cpu", torch.int64)
        pinned = self.device.type == "cuda"
        out = torch.empty((k.shape[0], self.block_elems), dtype=self.dtype,
                          pin_memory=pinned)
        torch.index_select(self.data, 0, k.clamp(0, self.num_blocks - 1),
                           out=out)
        out[k < 0] = 0
        return out.to(self.device, non_blocking=True)

    def write_blocks(self, keys: torch.Tensor, lines: torch.Tensor) -> None:
        k = keys.to("cpu", torch.int64)
        mask = k >= 0
        self.data[k[mask]] = lines.to("cpu")[mask].to(self.dtype)

    @staticmethod
    def from_array(arr, block_elems: int, device) -> "SimStorage":
        device = torch.device(device)
        flat = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1))
        data = _blocks_of(flat, block_elems)
        # a copy either way: writes never reach the caller's array
        data = data.pin_memory() if device.type == "cuda" else data.clone()
        return SimStorage(data=data, device=device)


@dataclasses.dataclass
class HBMStorage:
    """Device-resident block store."""

    data: torch.Tensor     # (num_blocks, block_elems) on the device

    @property
    def num_blocks(self) -> int:
        return self.data.shape[0]

    @property
    def block_elems(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    def fetch_blocks(self, keys: torch.Tensor) -> torch.Tensor:
        safe = keys.clamp(0, self.num_blocks - 1).to(torch.int64)
        out = self.data[safe]
        return torch.where((keys >= 0)[:, None], out, out.new_zeros(()))

    def write_blocks(self, keys: torch.Tensor, lines: torch.Tensor) -> None:
        """In place (the reference returns a new store)."""
        sel = torch.nonzero(keys >= 0).squeeze(1)
        if sel.numel() > 0:
            self.data.index_copy_(0, keys[sel].to(torch.int64),
                                  lines[sel].to(self.dtype))

    @staticmethod
    def from_array(arr, block_elems: int, device) -> "HBMStorage":
        flat = torch.as_tensor(np.ascontiguousarray(arr).reshape(-1))
        return HBMStorage(_blocks_of(flat, block_elems).to(device))
