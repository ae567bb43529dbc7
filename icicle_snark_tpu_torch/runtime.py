"""Device/runtime policy layer on torch.cuda.

The counterpart of icicle_snark_tpu/runtime.py and of ICICLE's runtime
C API and DeviceAPI registry:

  ICICLE                            here
  --------------------------------  --------------------------------
  dlopen'd backend .so registry     torch's CPU and CUDA devices
  icicle_set_device (thread-local)  set_device(): the op surface's default
  icicle_malloc / copy / memset     torch.empty / Tensor.to
  IcicleStream + async ops          PyTorch's current stream; sync()
  icicle_get_device_properties      device_properties()
  warmup                            warmup(): build the kernels, touch the card

The default device is what the op surface uses when it creates tensors of
its own without an input to take the device from (ops/ntt.py
`initialize_domain`). Ops on tensors run on the tensor's device. The
default is CUDA: "CUDA" without a card raises DeviceError, and nothing
falls back to the CPU. "CPU" selects the kernels' plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .errors import DeviceError

_DEVICE_ALIASES = {"CPU": "cpu", "CUDA": "cuda", "GPU": "cuda"}
_default = torch.device("cuda")


def available_devices() -> list:
    """Device types present: "cpu", and "cuda" when a card is."""
    return ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])


def set_device(device_type: str):
    """Select the op surface's default device (ICICLE: icicle_set_device).
    Accepts ICICLE's spellings ("CPU"/"CUDA")."""
    want = _DEVICE_ALIASES.get(device_type.upper())
    if want is None:
        raise DeviceError(f"unknown device type {device_type!r}")
    if want == "cuda" and not torch.cuda.is_available():
        raise DeviceError("no CUDA device available")
    global _default
    _default = torch.device(want)


def get_device() -> str:
    """The default device's type: "cuda" or "cpu"."""
    return _default.type


def default_device() -> torch.device:
    """The default device as a torch.device (raises DeviceError when it is
    CUDA and there is no card)."""
    if _default.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError("no CUDA device available: set_device('CPU') for the plain versions")
    return _default


def require_device(device) -> torch.device:
    """The device the caller asked for; raises when it is CUDA and no card
    is present (entry points never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain versions")
    return dev


@dataclass
class DeviceProperties:
    """ICICLE's DeviceProperties (icicle_get_device_properties)."""

    using_host_memory: bool
    num_memory_regions: int
    supports_pinned_memory: bool


def device_properties() -> DeviceProperties:
    host = get_device() == "cpu"
    return DeviceProperties(
        using_host_memory=host, num_memory_regions=1, supports_pinned_memory=not host)


def warmup():
    """Make later timings exclude first-use costs (ICICLE: warmup(stream)):
    on CUDA, build and load the kernels and run one small op on the card."""
    dev = default_device()
    if dev.type == "cuda":
        from . import kernels

        kernels.lib()
    x = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    (x + 1).sum().item()


def sync():
    """Block until all enqueued device work is complete (the analog of
    stream.synchronize); nothing to wait for on the CPU."""
    if get_device() == "cuda":
        torch.cuda.synchronize()
