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

import threading

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


class RouteCounts:
    """Process-wide named counters (thread-safe): the rows each string
    tier took (``string_routes``), and the Parquet reader's
    ``route_metrics`` and ``reader_metrics``."""

    def __init__(self, counters):
        self._counters = tuple(counters)
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._c = {k: 0 for k in self._counters}

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._c[name] += int(by)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)


# the string tiers' routes, in rows (ops/parse_uri.py, get_json_object.py,
# map_utils.py): "device" rows ran on the device tier; "host_by_config"
# rows on the host tier because the tier key (or a CPU column, or a
# degraded thread) chose it; the rest are the reference's own routes to
# the host tier within a device-tier call
string_routes = RouteCounts((
    "parse_uri_device", "parse_uri_host_by_config", "parse_uri_host_key",
    "get_json_device", "get_json_canonical", "get_json_span_normalized",
    "get_json_host_uncertified", "get_json_host_path",
    "get_json_host_by_config",
    "from_json_device", "from_json_host_backslash", "from_json_host_deep",
    "from_json_host_by_config"))
