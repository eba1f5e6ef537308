"""Device resolution for the port (counterpart of galah_tpu/utils/platform.py).

The CLI resolves the device once, here, and passes it down explicitly;
nothing in the package reads a global default device.

GALAH_TPU_PLATFORM:
- unset or "gpu": the first CUDA device, `cuda:0` (resolve_device), or
  every visible CUDA device, the local shards (resolve_devices, as
  `jax.local_devices()` gives them; processes on one host are given
  distinct cards by CUDA_VISIBLE_DEVICES);
- "cpu": the CPU.

Without a CUDA device the run stops unless the CPU was asked for: it
never falls back to the CPU silently.
"""

from __future__ import annotations

import os
from typing import List

import torch

NO_CUDA_MESSAGE = (
    "no CUDA device (set GALAH_TPU_PLATFORM=cpu to run on the CPU)"
)


def resolve_device(platform: str | None = None) -> torch.device:
    """The device named by `platform` (default: $GALAH_TPU_PLATFORM)."""
    if _platform(platform) == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", 0)


def resolve_devices(platform: str | None = None) -> List[torch.device]:
    """The local shards on the platform named by `platform` (default:
    $GALAH_TPU_PLATFORM): every visible CUDA device in index order, or
    [cpu]."""
    if _platform(platform) == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _platform(platform: str | None) -> str:
    """"cpu" or "gpu"; raises for another name, and for "gpu" without a
    CUDA device."""
    if platform is None:
        platform = os.environ.get("GALAH_TPU_PLATFORM", "")
    platform = platform.strip().lower()
    if platform == "cpu":
        return platform
    if platform not in ("", "gpu"):
        raise ValueError(
            f"GALAH_TPU_PLATFORM={platform!r} is not supported by "
            "galah_tpu_torch (use gpu or cpu)"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CUDA_MESSAGE)
    return "gpu"
