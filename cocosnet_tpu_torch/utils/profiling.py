"""Profiling hooks: the port's counterpart of cocosnet_tpu/utils/profiling.py,
with torch.profiler in place of jax.profiler.

Usage (the train twin traces its third step under --profile_dir):
    with maybe_trace(opt.profile_dir, enabled=(i == 2)):
        losses, visuals = train_step(state, batch, lr)

The trace is a Chrome trace (chrome://tracing, Perfetto) of the host's ops
and, on a CUDA device, the kernels' device time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def maybe_trace(logdir: Optional[str], enabled: bool = True,
                name: str = "trace") -> Iterator[None]:
    """Profiles the block into <logdir>/<name>.json when logdir is set and
    enabled is true; otherwise does nothing."""
    if not (logdir and enabled):
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{name}.json")
    prof.export_chrome_trace(path)
    print(f"wrote the profile to {path}")


class Throughput:
    """Images/sec EMA for step logging."""

    def __init__(self, beta: float = 0.9):
        self.beta = beta
        self.value = None
        self._last = None

    def step(self, n_images: int) -> float:
        now = time.perf_counter()
        if self._last is not None:
            ips = n_images / (now - self._last)
            self.value = (ips if self.value is None
                          else self.beta * self.value + (1 - self.beta) * ips)
        self._last = now
        return self.value or 0.0
