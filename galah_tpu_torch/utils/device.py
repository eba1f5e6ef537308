"""Device resolution for the port (counterpart of galah_tpu/utils/platform.py).

The CLI resolves the device once, here, and passes it down explicitly;
nothing in the package reads a global default device.

GALAH_TPU_PLATFORM:
- unset or "gpu": the first CUDA device, `cuda:0`;
- "cpu": the CPU.

Without a CUDA device the run stops unless the CPU was asked for: it
never falls back to the CPU silently.
"""

from __future__ import annotations

import os

import torch

NO_CUDA_MESSAGE = (
    "no CUDA device (set GALAH_TPU_PLATFORM=cpu to run on the CPU)"
)


def resolve_device(platform: str | None = None) -> torch.device:
    """The device named by `platform` (default: $GALAH_TPU_PLATFORM)."""
    if platform is None:
        platform = os.environ.get("GALAH_TPU_PLATFORM", "")
    platform = platform.strip().lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "gpu"):
        raise ValueError(
            f"GALAH_TPU_PLATFORM={platform!r} is not supported by "
            "galah_tpu_torch (use gpu or cpu)"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CUDA_MESSAGE)
    return torch.device("cuda", 0)
