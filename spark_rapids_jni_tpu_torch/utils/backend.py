"""Tier predicate shared by the dispatchers that keep two execution tiers
(the JAX package's utils/backend.py).

An op with a device tier (torch ops on the caller's device) and a host
tier (native C++) picks one through an auto/on/off-style config key. Here
"auto" follows the device the caller targets: the device tier for a CUDA
caller, the host tier for a CPU caller (the JAX package follows
``jax.default_backend()``). A forced value picks a tier on any device, so
the CPU tests run the device tier's torch ops on the CPU with
``"device"``.
"""

from __future__ import annotations

import torch


def tier_is_device(flag_key: str, device: torch.device,
                   device_value: str = "device",
                   host_value: str = "native") -> bool:
    """``device_value`` (or "on") forces the device tier, ``host_value``
    (or "off") the host tier; anything else ("auto") takes the device
    tier for a CUDA ``device`` unless the calling thread is degraded."""
    from . import config
    v = config.get(flag_key)
    if v == device_value or v == "on":
        return True
    if v == host_value or v == "off":
        return False
    # degraded task (faultinj/guard.py ladder): auto tiers resolve to the
    # host path, the device being presumed unhealthy for this thread
    from ..faultinj.guard import degraded_mode
    if degraded_mode():
        return False
    return torch.device(device).type == "cuda"
