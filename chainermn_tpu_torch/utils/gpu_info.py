"""The card's published rates, shared by every bound and MFU of the port.

Counterpart of ``chainermn_tpu/utils/tpu_info.py`` (which holds TPU peaks
only).  One table, keyed by a lowercase substring of
``torch.cuda.get_device_name()``, most specific key first, so that every
bound and every MFU the port reports follows the card it ran on.  Values
are NVIDIA's H100 data sheet, dense (half the "with sparsity" figures):

* bf16/fp16 tensor cores, TFLOP/s: SXM5 989.4, NVL 835.5, PCIe 756.5;
* device memory: SXM5 3.35 TB/s (HBM3), NVL 3.9 TB/s, PCIe 2.0 TB/s;
* float32 outside the tensor cores, TFLOP/s: SXM5 66.9, NVL 60, PCIe 51.

These are the rates at the card's full power limit; a card set below it
(``nvidia-smi --query-gpu=power.limit``) runs slower, so every number is
reported beside the card's name and limit.  An unknown card gets the SXM5
row and is marked ``peak_assumed`` by its callers (``matched`` is None),
so that a utilization against a guessed peak is never presented as fact.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Card:
    """Published rates of one card."""

    peak_tflops: float       # dense bf16/fp16 tensor cores
    hbm_bytes_per_s: float   # device memory
    f32_tflops: float        # float32 outside the tensor cores


CARDS = {
    "h100 nvl": Card(835.5, 3.9e12, 60.0),
    "h100 pcie": Card(756.5, 2.0e12, 51.0),
    "h100 80gb hbm3": Card(989.4, 3.35e12, 66.9),  # SXM5
}
PEAK_TFLOPS = {k: c.peak_tflops for k, c in CARDS.items()}

_DEFAULT = "h100 80gb hbm3"  # assumed when the name is unknown


def device_name(device=None) -> str:
    """The card's name: ``device`` itself when it is a string, else
    ``torch.cuda.get_device_name(device)`` (an index, a ``torch.device`` or
    None for the current one)."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device
    import torch
    return torch.cuda.get_device_name(device)


def card_info(device=None) -> Tuple[Card, Optional[str]]:
    """``(card, matched)``: the rates of ``device`` (see
    :func:`device_name`) and the table key that matched its name, or the
    assumed SXM5 rates and ``None`` for a card the table does not know."""
    name = device_name(device).lower()
    for key, card in CARDS.items():
        if key in name:
            return card, key
    return CARDS[_DEFAULT], None


def peak_tflops_info(device=None) -> Tuple[float, Optional[str]]:
    """``(peak, matched)``: the dense bf16 peak of ``device`` and the key
    that matched, ``None`` when the peak is assumed (ADVICE r5)."""
    card, matched = card_info(device)
    return card.peak_tflops, matched


def smi_line(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (card ``index``): the
    label every measurement of the card is reported beside."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[index]


__all__ = ["CARDS", "Card", "PEAK_TFLOPS", "card_info", "device_name",
           "peak_tflops_info", "smi_line"]
