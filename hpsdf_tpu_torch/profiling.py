"""Phase timing + device profiling.

The counterpart of ``hpsdf_tpu/profiling.py``. The reference's only
observability is wall-clock phase timing with std::chrono around whole
benchmark phases (Source/Tests/HPBenchmarks.cpp:27-47,
MeshingBenchmarks.cpp:26-34) plus a per-merge printf behind
Config::enableLogging (Source/HP/Octree.cpp:292-296). This module provides
the same phase-level wall clocks, made device-aware (a phase whose result
holds a CUDA tensor waits for the card with ``torch.cuda.synchronize``, so
it measures completed device work, not the enqueue), and a bridge to
``torch.profiler`` for per-kernel traces viewable in Perfetto or
chrome://tracing.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any

import torch


def _cuda_devices(x: Any) -> set:
    """The CUDA devices of every tensor in ``x`` (a tensor, or lists, tuples,
    dicts and dataclass-like objects of them)."""
    if isinstance(x, torch.Tensor):
        return {x.device} if x.device.type == "cuda" else set()
    if isinstance(x, dict):
        x = list(x.values())
    elif hasattr(x, "__dict__") and not isinstance(x, type):
        x = list(vars(x).values())
    if isinstance(x, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in x))
    return set()


def block_until_ready(x: Any) -> Any:
    """Wait until the card has finished the work behind ``x``: a
    ``torch.cuda.synchronize`` of each CUDA device a tensor of ``x`` is on
    (CPU tensors are ready when returned). Returns ``x``."""
    for dev in _cuda_devices(x):
        torch.cuda.synchronize(dev)
    return x


class PhaseTimer:
    """Accumulating named phase wall-clocks (the chrono-around-phases
    pattern). ``block=True`` waits for device completion before stopping
    the clock -- with asynchronous CUDA launches, an unblocked timer
    measures only enqueue time."""

    def __init__(self):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, result: Any = None, block: bool = True):
        t0 = time.perf_counter()
        out: list = []
        try:
            yield out
        finally:
            if block:
                for x in (out if result is None else [result]):
                    block_until_ready(x)
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [f"{k}: {v:.4f} s over {self.counts[k]} call(s)"
                 for k, v in sorted(self.times.items())]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Per-kernel profiling via ``torch.profiler``: the CPU and, where
    there is one, the CUDA device, written as a Chrome trace
    (``trace_<pid>_<ns>.json``) into ``log_dir``; open it with Perfetto
    or chrome://tracing."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def timed(fn, *args, block: bool = True, **kw):
    """(result, seconds) of one call, blocking on the result."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    if block:
        block_until_ready(out)
    return out, time.perf_counter() - t0
