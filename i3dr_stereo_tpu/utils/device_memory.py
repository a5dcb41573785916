"""Device memory introspection — the cudaMem analog.

The reference links a binary-only ``libcudaMem.so`` exposing
getMemFree/Used/Total (include/stereoMatcher/cudaMem.h:14-17) so nodes
can report GPU headroom. Equivalent here over PJRT memory stats, with the
same accessor surface.
"""

from __future__ import annotations

from typing import Optional

import jax


class DeviceMem:
    """getMemFree/Used/Total for a jax device (bytes)."""

    def __init__(self, device: Optional[jax.Device] = None):
        self.device = device if device is not None else jax.devices()[0]

    def _stats(self) -> dict:
        try:
            return self.device.memory_stats() or {}
        except Exception:
            return {}

    def get_mem_total(self) -> int:
        s = self._stats()
        return int(s.get("bytes_limit", s.get("bytes_reservable_limit", 0)))

    def get_mem_used(self) -> int:
        return int(self._stats().get("bytes_in_use", 0))

    def get_mem_free(self) -> int:
        total = self.get_mem_total()
        return max(total - self.get_mem_used(), 0) if total else 0

    def summary(self) -> dict:
        return {
            "device": str(self.device),
            "total": self.get_mem_total(),
            "used": self.get_mem_used(),
            "free": self.get_mem_free(),
        }
