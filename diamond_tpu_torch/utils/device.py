"""Device choice and DP routing for the PyTorch/CUDA port.

Entry points run on the CUDA card unless the caller asks for the CPU:
``device="cpu"`` in code, ``DIAMOND_TPU_TORCH_DEVICE=cpu`` for the CLI.
Nothing falls back quietly: without a card, and without that request,
``resolve_device`` raises ``NoDeviceError``.

The extension DP's score-only round goes through ``ops.swipe_device.DeviceDP``
on either device: on ``cuda`` it launches the hand-written kernel, on a CPU
the caller asked for it runs the kernel's plain PyTorch version.

  DIAMOND_TPU_TORCH_DEVICE_DP=0    send all DP to host C++ (the kill switch)
  DIAMOND_TPU_TORCH_DP_MIN_CELLS   per-job routing threshold (default 0)
  DIAMOND_TPU_TORCH_STAGE12        1: stage 1/2 seeding on the resolved device
                                   (ops.stage12_device: the fused pair kernel
                                   on the card, its plain version on a CPU);
                                   0 or unset: the fused host C++ pass (the
                                   default, as in diamond_tpu)
"""
from __future__ import annotations

import os


class NoDeviceError(RuntimeError):
    """A CUDA device was required (the default) and none is available."""


def resolve_device(device: str | None = None) -> str:
    """The torch device an entry point runs on: ``device`` if given, else
    DIAMOND_TPU_TORCH_DEVICE, else ``cuda``.  ``cuda`` without a card
    raises."""
    d = device or os.environ.get("DIAMOND_TPU_TORCH_DEVICE") or "cuda"
    if d == "cpu":
        return d
    if not (d == "cuda" or d.startswith("cuda:")):
        raise ValueError(f"unknown device {d!r}: expected 'cuda' or 'cpu'")
    import torch

    if not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device is available; set DIAMOND_TPU_TORCH_DEVICE=cpu "
            "(or pass device='cpu') to run on the CPU")
    return d


def device_dp_enabled() -> bool:
    return os.environ.get("DIAMOND_TPU_TORCH_DEVICE_DP") != "0"


def stage12_device_enabled() -> bool:
    """Stage 1/2 on the device only when DIAMOND_TPU_TORCH_STAGE12 asks for
    it (any value but "0"); the host pass stays the default."""
    v = os.environ.get("DIAMOND_TPU_TORCH_STAGE12")
    return bool(v) and v != "0"
