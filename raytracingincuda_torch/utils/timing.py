"""Render timing and the device record.

``RenderTimer`` brackets a render the way the reference brackets its
kernel with ``cudaEvent``s: events on the current stream, then a
synchronise, then ``elapsed_time``. On a CPU device it reads the host
clock. ``device_record`` names the card a number was taken on.
"""
from __future__ import annotations

import subprocess
import time

import torch


class RenderTimer:
    """``with RenderTimer(device) as t: ...`` then ``t.ms``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.ms = float("nan")

    def __enter__(self):
        if self.device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self._end.record()
            self._end.synchronize()
            self.ms = self._start.elapsed_time(self._end)
        else:
            self.ms = (time.perf_counter() - self._t0) * 1e3
        return False


def nvidia_smi(query: str) -> str:
    """One ``nvidia-smi --query-gpu`` read (csv, no header), first card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def device_record() -> dict:
    """Name, power limit, CUDA and driver versions of CUDA device 0."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    return {
        "name_power_limit": nvidia_smi("name,power.limit"),
        "torch_cuda": torch.version.cuda,
        "driver": nvidia_smi("driver_version"),
        "device_name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
