"""The per-layer metrics that read the program's span log
(`gswt_renderer_tpu_torch/core/hostprof.py` `trace()`), on the CPU:

    python -m pytest gswt_bench/tests/test_bench_span_readers.py -q
"""

import json
import os

import pytest
import torch

from conftest import REPO
from gswt_bench import harness

SPAN_METRICS = ("host.lead_ms", "host.hidden_syncs", "project.device_ms",
                "bin.device_ms", "back.device_ms", "bin.pairs_used_pct")
CARD_ONLY = SPAN_METRICS[:5]


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_a_traced_cpu_run_reads_pair_use_and_no_card_metric(checkout):
    """The span log's readers in a traced run on the CPU: the pair slots
    used are read; the device times and the flagged syncs exist only on the
    card, so those metrics are absent, not CPU numbers."""
    path = os.path.join(checkout, "BENCHMARK.json")
    bench = json.load(open(path))
    for m in bench["per_layer"]:
        if m["name"] in SPAN_METRICS:
            m["workloads"].append("small.still")
    with open(path, "w") as f:
        json.dump(bench, f)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # light on the CPU beside the suite's other runs
    try:
        out = harness.run_cell("small.still", 4294967311, 2.0, True, device="cpu",
                               root=checkout, here=os.path.join(checkout, "gswt_bench"))
    finally:
        torch.set_num_threads(threads)
    got = out["metrics"]
    assert out["correct"], out["compared"]
    assert 0.0 < got["bin.pairs_used_pct"]["value"] <= 100.0
    assert got["bin.pairs_used_pct"]["unit"] == "%"
    assert not set(CARD_ONLY) & set(got), got
    assert "host.dispatch_ms" in got and "host.wait_ms" in got


def test_span_readers_read_nothing_from_a_program_without_the_log(monkeypatch):
    """A program without hostprof.trace: every reader returns None and
    raises nothing."""
    from gswt_renderer_tpu_torch.core import hostprof
    monkeypatch.delattr(hostprof, "trace")
    for name in SPAN_METRICS:
        assert harness.reader(name)({}) is None, name


def test_span_readers_against_a_hand_worked_log(monkeypatch):
    """Two frames on the card: the device 30 and 10 ms behind the host at
    each frame's start; projection 4 and 6 ms, binning 2 and 2, the back 9
    and 11 on the device; one flagged call in projection, one in a sync.*
    section (known), one with no section open; 60 and 90 pairs of 150."""
    from gswt_renderer_tpu_torch.core import hostprof
    S = hostprof.Span

    def span(name, frame, h0, d0=None, d1=None, syncs=0):
        return S(name, frame, 1, None, h0, h0 + 0.001, 0.001, d0, d1, syncs, {})
    spans = (span("frame", 1, 1.000, 1.030, 1.060),
             span("render.front.project", 1, 1.001, 1.031, 1.035, syncs=1),
             span("render.front.bin", 1, 1.002, 1.035, 1.037),
             span("sync.aux", 1, 1.0025, syncs=1),
             span("render.back", 1, 1.003, 1.037, 1.046),
             span("frame", 2, 2.000, 2.010, 2.040),
             span("render.front.project", 2, 2.001, 2.011, 2.017),
             span("render.front.bin", 2, 2.002, 2.017, 2.019),
             span("render.back", 2, 2.003, 2.019, 2.030))
    frames = {0: dict(n_pairs=150, capacity=150),  # before the window
              1: dict(n_pairs=60, capacity=150), 2: dict(n_pairs=90, capacity=150)}
    log = hostprof.Trace(spans, frames, 0, True, 1, {})
    monkeypatch.setattr(hostprof, "trace", lambda: log)
    read = {name: harness.reader(name)({}) for name in SPAN_METRICS}
    assert read["host.lead_ms"] == pytest.approx(20.0)
    assert read["host.hidden_syncs"] == pytest.approx(1.0)
    assert read["project.device_ms"] == pytest.approx(5.0)
    assert read["bin.device_ms"] == pytest.approx(2.0)
    assert read["back.device_ms"] == pytest.approx(10.0)
    assert read["bin.pairs_used_pct"] == pytest.approx(50.0)
    # without a card: no device times, no flagged calls counted
    log = hostprof.Trace(tuple(s._replace(device_start=None, device_end=None)
                               for s in spans), frames, 0, False, 0, {})
    read = {name: harness.reader(name)({}) for name in SPAN_METRICS}
    assert all(read[name] is None for name in CARD_ONLY), read
    assert read["bin.pairs_used_pct"] == pytest.approx(50.0)


def test_device_spans_are_reported_only_where_the_device_runs_behind():
    """A stage's device span is its busy time only where the device runs
    behind the host by more than the stage's host time: the device-bound
    dense still reports all six span metrics; the host-bound sky still the
    lead, the flagged syncs and the pair slots, not the three spans."""
    b = _bench()

    def traced(cell):
        return {m["name"] for m in harness.metrics_of(b, harness.cell_of(b, cell), True)}
    assert set(SPAN_METRICS) <= traced("dense_tiles_1080p.still")
    assert set(SPAN_METRICS) & traced("paper_sky_1080p.still") == {
        "host.lead_ms", "host.hidden_syncs", "bin.pairs_used_pct"}
