"""Phase timers and the profiler bridge of hpsdf_tpu_torch (the counterpart
of tests/test_profiling.py: the reference's chrono-around-phases
benchmarking, Source/Tests/HPBenchmarks.cpp:27-47, made device-aware)."""

import dataclasses

import torch

from hpsdf_tpu_torch import profiling

from .test_torch_query import few_torch_threads  # noqa: F401


def test_phase_timer_accumulates():
    pt = profiling.PhaseTimer()
    with pt.phase("a") as out:
        out.append(torch.arange(8) * 2)
    with pt.phase("a") as out:
        out.append(torch.arange(8) + 1)
    with pt.phase("b"):
        pass
    assert pt.counts["a"] == 2 and pt.counts["b"] == 1
    assert pt.times["a"] > 0.0
    rep = pt.report()
    assert "a:" in rep and "b:" in rep


def test_timed_blocks_on_result():
    x = torch.ones((256, 256), dtype=torch.float64)
    out, dt = profiling.timed(lambda v: v @ v, x)
    assert out.shape == (256, 256) and dt > 0.0


def test_device_trace_writes(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        torch.sum(torch.arange(16))
    traces = list(tmp_path.rglob("*.json"))
    assert traces, "no profile output written"
    assert "aten::sum" in traces[0].read_text()


def test_block_until_ready_walks_containers():
    @dataclasses.dataclass
    class Box:
        t: torch.Tensor

    x = [torch.ones(3), {"a": (torch.zeros(2), 1.0)}, Box(torch.ones(1))]
    assert profiling.block_until_ready(x) is x
    # CPU tensors need no device wait
    assert profiling._cuda_devices(x) == set()
