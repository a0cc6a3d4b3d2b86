"""Timing and device identification shared by the benchmark scripts."""

from __future__ import annotations

import subprocess
import time

import torch


def time_ms(fn, reps: int, device) -> float:
    """Mean time of fn over `reps` back-to-back calls after one warm-up
    call: CUDA events on the card, the host clock on the CPU."""
    device = torch.device(device)
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_label(device) -> str:
    """What the numbers were taken on: the card's name and power limit as
    nvidia-smi reports them, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
