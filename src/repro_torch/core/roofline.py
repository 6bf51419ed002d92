"""Roofline terms from counters, on an NVIDIA H100.

  compute    = flops / PEAK_FLOPS      (dense bf16 on the tensor cores)
  memory     = bytes / HBM_BW
  collective = link_bytes / NVLINK_BW  (ring cost through the busiest link)

The figures are NVIDIA's data-sheet peaks (dense, no sparsity), picked by
the card's name (:func:`card_for`): the SXM, PCIe and NVL parts differ.
The CPU and the meta device get the SXM figures, so counts made off the
card (the tests, the shape-only counters) mean the card the port targets.
Every term is per device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.counters import Counters


@dataclasses.dataclass(frozen=True)
class Card:
    """Data-sheet peaks of one card, per second."""
    name: str
    bf16_flops: float       # dense bf16 / fp16 on the tensor cores
    f32_flops: float        # float32 outside the tensor cores
    hbm_bw: float           # device-memory bytes
    nvlink_bw: float        # NVLink bytes, one direction
    hbm_bytes: float        # device memory
    tf32_flops: float       # dense TF32 on the tensor cores (~half of bf16)


H100_SXM = Card("H100 SXM", 989e12, 67e12, 3.35e12, 450e9, 80e9, 495e12)
H100_PCIE = Card("H100 PCIe", 756e12, 51e12, 2.0e12, 300e9, 80e9, 378e12)
H100_NVL = Card("H100 NVL", 835e12, 60e12, 3.9e12, 300e9, 94e9, 417.5e12)

PEAK_FLOPS = H100_SXM.bf16_flops
HBM_BW = H100_SXM.hbm_bw
NVLINK_BW = H100_SXM.nvlink_bw


def card_for(device_name: str) -> Card:
    """The data-sheet card a ``torch.cuda.get_device_name()`` string names
    (SXM unless the name says PCIe or NVL)."""
    if "NVL" in device_name:
        return H100_NVL
    if "PCIe" in device_name:
        return H100_PCIE
    return H100_SXM


def card_for_device(device=None) -> Card:
    """The card behind ``device``: the named CUDA card, else (CPU, meta)
    the SXM part."""
    dev = torch.device(device if device is not None else "cpu")
    if dev.type != "cuda":
        return H100_SXM
    return card_for(torch.cuda.get_device_name(dev))


def peak_ops(dtype, card: Card = H100_SXM) -> float:
    """Peak operations per second for work in ``dtype`` (a torch dtype or
    its name): the tensor cores' for bf16/fp16, the CUDA cores' for f32."""
    name = str(dtype).split(".")[-1]
    return card.f32_flops if name == "float32" else card.bf16_flops


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Lower-bound step time (terms fully overlapped)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def serial_s(self) -> float:
        """Upper-bound step time (no overlap)."""
        return self.compute_s + self.memory_s + self.collective_s

    def fraction(self) -> float:
        """Roofline fraction: ideal compute time / achievable bound."""
        return self.compute_s / self.bound_s if self.bound_s else 0.0

    def to_json(self):
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "dominant": self.dominant,
                "bound_s": self.bound_s, "fraction": self.fraction()}


def from_counters(c: Counters, card: Optional[Card] = None) -> Roofline:
    card = card or H100_SXM
    return Roofline(compute_s=c.flops / card.bf16_flops,
                    memory_s=c.bytes / card.hbm_bw,
                    collective_s=c.link_bytes / card.nvlink_bw)
