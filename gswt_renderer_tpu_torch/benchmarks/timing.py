"""Timing and device identification shared by the benchmark scripts."""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from ..ops import kernels


def open_device(device, tag: str) -> torch.device:
    """The device a script runs on (the card unless asked for the CPU; no
    fallback), announced with its label as `<tag> device: <label>`, with
    the CUDA kernels built first on the card."""
    device = kernels.resolve_device(device)
    print(f"{tag} device: {device_label(device)}", flush=True)
    if device.type == "cuda":
        kernels.build_all()
    return device


def device_complete_ms(fn, drain, n: int, warm: int = 2) -> list:
    """Host-clock ms of each of n calls of fn, each stopped after drain()
    (on the card a synchronize: the call's device work is done), after
    `warm` untimed calls."""
    for _ in range(warm):
        fn()
    drain()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        drain()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def event_ms(fn, n: int, device, reps: int = 1) -> list:
    """ms per call of fn in each of n windows of `reps` back-to-back calls:
    CUDA events on the card, the host clock on the CPU (after one warm-up
    call)."""
    return [time_ms(fn, reps, device) for _ in range(n)]


def spread(ts) -> dict:
    """The median and the min-max of a list of times."""
    a = np.asarray(ts, np.float64)
    return dict(median=float(np.median(a)), min=float(a.min()),
                max=float(a.max()), n=int(a.size))


def fmt(s: dict) -> str:
    """A spread as `median M ms (min-max A-B, n N)`."""
    return (f"median {s['median']:.3f} ms (min-max {s['min']:.3f}-"
            f"{s['max']:.3f}, n {s['n']})")


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
