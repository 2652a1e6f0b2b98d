"""The card's figures: a frozen ``DeviceSpec`` per supported card, and
``device_spec`` to read which card this is.

Counterpart of the JAX package's ``launch/mesh.py``.  That module builds
the 256- and 512-chip production meshes and a host mesh, and holds the
TPU v5e peak figures the dry-run's roofline divides by.  One card needs no
mesh, so the port has no mesh constructor; it keeps the other half, the
peak figures, for the card it runs on.  No TPU figure is carried over.

The table's figures are the vendor's data-sheet peaks, not measurements:
the roofline's ``t_compute`` / ``t_memory`` are the least time a step
could take at those rates.
"""
from __future__ import annotations

import dataclasses
import subprocess
from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    peak_bf16_flops: float      # dense bf16 tensor-core FLOP/s
    hbm_bw: float               # HBM bytes/s
    hbm_bytes: float            # device memory; the card's own when read
    link_bw: float              # NVLink bytes/s per direction
    sm_count: int
    card: str = ""              # torch's name of the card it was read from
    power_limit: str = ""       # nvidia-smi's power.limit of that card


# NVIDIA H100 Tensor Core GPU data sheet, SXM5 column: 989.4 TFLOP/s dense
# bf16 (1 979 with sparsity), 3.35 TB/s HBM3, 80 GB, NVLink 900 GB/s (450
# each direction), 132 SMs.
H100_SXM5_80GB = DeviceSpec("H100-SXM5-80GB", peak_bf16_flops=989e12,
                            hbm_bw=3.35e12, hbm_bytes=80e9, link_bw=450e9,
                            sm_count=132)

SPECS: Dict[str, DeviceSpec] = {s.name: s for s in (H100_SXM5_80GB,)}

# torch's device name and SM count of each table entry's card
_CARDS = {("NVIDIA H100 80GB HBM3", 132): "H100-SXM5-80GB"}


def _power_limit(index: int) -> str:
    """``power.limit`` of card ``index`` as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={index}"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().split(",")[-1].strip()


def device_spec(device: "Optional[str | torch.device]" = None
                ) -> DeviceSpec:
    """The spec of a card.

    ``device`` names a table entry (``"H100-SXM5-80GB"``), or is a CUDA
    device (``None``: the current one): then the card's name, SM count and
    memory are read from ``torch.cuda.get_device_properties`` and its power
    limit from ``nvidia-smi``, and the table's entry is returned with the
    card's own memory size and power limit.  A card that is not in the
    table raises: there is no default."""
    if isinstance(device, str) and device in SPECS:
        return SPECS[device]
    try:
        dev = torch.device("cuda" if device is None else device)
    except RuntimeError:
        dev = None
    if dev is None or dev.type != "cuda":
        raise ValueError(f"device_spec: {device!r} is neither a table entry "
                         f"({sorted(SPECS)}) nor a CUDA device")
    if not torch.cuda.is_available():
        raise RuntimeError("device_spec: no CUDA device "
                           "(torch.cuda.is_available() is False)")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    key = (props.name, props.multi_processor_count)
    if key not in _CARDS:
        raise ValueError(f"device_spec: no figures for {props.name} with "
                         f"{props.multi_processor_count} SMs; the table has "
                         f"{sorted(SPECS)}")
    return dataclasses.replace(SPECS[_CARDS[key]],
                               hbm_bytes=float(props.total_memory),
                               card=props.name,
                               power_limit=_power_limit(index))
