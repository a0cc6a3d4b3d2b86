"""Host-section profiler and span log: wall time per named section of the
frame loop, and while on, one record per section on the device's clock.

A section is ``with _hprof("name"):`` (``_hprof("name", device)`` for a
section on the render thread that launches device work). Off, the default,
a section tests one flag and records nothing, and ``next_frame`` (which
``Engine.frame`` calls to number its frames) increments one integer.

While on (``set_host_prof(True)``):

- **Aggregates.** Every section adds to ``HOST_PROF[name] = [n, total_s,
  self_s]`` its count, its wall seconds and its self seconds (its time less
  that of the sections nested in it on the same thread, each with the
  profiler's own work around it: its record, events and range count in no
  section's self time), to locate the host work the device does not hide.
  ``HOST_PROF`` keeps what it recorded until it is cleared.
- **Spans.** Every section also appends one record to the span log (at most
  ``LOG_CAP``; the rest are counted as dropped): its name, the frame id, the
  thread, the index in the log of the section it is nested in, its host
  start and end (``time.perf_counter``) and its self seconds. The frame id
  is the render thread's current one (``next_frame``), or on the builder
  thread the id of the frame whose pose its work was given
  (``set_thread_frame``). ``set_host_prof(True)`` clears the log;
  ``trace()`` reads it.
- **Device times.** A section given a CUDA device records a timing event on
  that device's current stream at its entry and at its exit. The device
  start is when the device reached the entry event (it had finished all
  that was launched before), the device end when it had finished all that
  the section launched: idle time inside the section counts. Turning the
  profiler on synchronises once and records an anchor event (its host time
  the midpoint of the host clock around it); turning it off resolves every
  event onto the host clock through the anchor. The caller drains first.
  A section never waits for the device; only turning the profiler on and
  off does.
- **Profiler ranges.** Every section entered while ``torch.profiler`` is
  recording opens ``record_function("gswt." + name)``, so the trace names
  each device operation and idle gap by the section that launched it (when
  nothing records, a range would record nothing, and is not opened).
- **Hidden waits.** On the card, ``torch.cuda.set_sync_debug_mode("warn")``
  flags each call that synchronises; each one is counted on the innermost
  section open on its thread (``Span.syncs``), or as unsectioned. Inside a
  ``sync.*`` section or ``render.drain`` a flagged call is a known wait;
  anywhere else a hidden one. Mode and warning filters are restored when
  the profiler is turned off.
- **Counters.** ``add`` adds counts to the innermost section open on the
  thread (a sort's merge work), ``annotate`` sets counters on a section's
  span after it has closed (``_hprof.span()``: the frame that first drew a
  sort); ``count_frame`` files a frame's counts under its id once the
  render thread has read them back (``Renderer._drain_one`` / ``exactly``):
  the pair demands and capacities, and the proxy grid's
  ``proxy_tris_live`` and ``proxy_tris_thin`` (``ops/proxy.py
  grid_counts``, computed only while on).
  ``benchmarks/profile_hostloop.py`` reads the builder's counters and the
  frames' pair counts; ``gswt_bench/metrics`` the rest.

The frame's sections (``render/pipeline.py``, ``engine/engine.py``,
``ops/binning.py``): ``frame`` (all of one
``Engine.frame``), ``frame.update_pump``, ``frame.stage``; ``stage.build``,
``stage.sort``, ``stage.plan``, ``stage.prep`` (on the builder thread when
the Engine has one); ``render.sat_cut``, ``render.uniforms``,
``render.plan``, ``render.front.project``, ``.background``, ``.skybox``,
``.proxy`` (with ``.proxy.raster``: the ground's triangle planes, raster and
maps; ``.proxy.shade``: its footprint, mip sampling and colour), ``.bin``,
``render.back``, ``render.aux``, ``render.drain``; and
one ``sync.<where>`` for each call on the frame path that waits for the
device: a read of a device value on the host, or a copy to the device from
pageable host memory, which PyTorch makes synchronous. ``frame`` and the
``render.*`` sections but ``render.drain`` carry device times.
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import namedtuple

HOST_PROF: dict = {}
_PROF_ON = False
_lock = threading.Lock()
_local = threading.local()

# the span log's bound: records beyond it are counted, not kept
LOG_CAP = 1 << 18
# the message of a call PyTorch's sync debug mode flags
SYNC_WARNING = "called a synchronizing CUDA operation"

Span = namedtuple("Span", (
    "name", "frame", "thread", "parent", "host_start", "host_end", "self_s",
    "device_start", "device_end", "syncs", "counters"))
Span.__doc__ = """One section as it ran: times in seconds on the host's
perf_counter clock; device_start/device_end None for a section given no
CUDA device (or before the profiler was turned off); parent the index in
the log of the section it was nested in on its thread, or None; syncs the
flagged synchronising calls made while it was the innermost open section;
counters what it noted."""
Trace = namedtuple("Trace", (
    "spans", "frames", "dropped", "syncs_counted", "unsectioned_syncs",
    "sync_sites"))
Trace.__doc__ = """The span log (trace()): spans in the order they were
entered; frames {frame id: counts filed by count_frame}; dropped the
records past LOG_CAP; syncs_counted whether flagged synchronising calls
were counted (on the card only); unsectioned_syncs those made with no
section open (or in one whose record was dropped); sync_sites {(innermost
section or None, file, line): flagged calls} where each was made."""

_frame = 0          # the render thread's frame id (next_frame)
_log: list = []     # _Rec, in order of entry
_dropped = 0
_frames: dict = {}  # frame id -> counts
_unsectioned = 0
_sync_sites: dict = {}  # (section, file, line) -> flagged calls
_syncs_counted = False
_torch = None       # torch, imported when the profiler is first turned on
_anchor = None      # (event, host seconds) while device times are taken
_sync_restore = None  # (debug mode, showwarning, filters) to put back
_streams: dict = {}  # device index -> (raw current stream, its Stream)


class _Rec:
    __slots__ = ("index", "name", "frame", "thread", "parent", "t0", "t1",
                 "self_s", "ev0", "ev1", "d0", "d1", "syncs", "counters")

    def __init__(self, index, name, frame, thread, parent):
        self.index, self.name, self.frame, self.thread, self.parent = (
            index, name, frame, thread, parent)
        self.t0 = self.t1 = self.self_s = None
        self.ev0 = self.ev1 = self.d0 = self.d1 = None
        self.syncs = 0
        self.counters = None


def next_frame() -> int:
    """Number the next frame on the render thread (Engine.frame); its
    sections carry the id returned."""
    global _frame
    _frame += 1
    return _frame


def current_frame() -> int:
    """The frame id the sections opened on this thread now carry."""
    f = getattr(_local, "frame", None)
    return _frame if f is None else f


def set_thread_frame(frame) -> None:
    """On a worker thread: give the sections it opens from now on the id of
    the frame whose request it works on (None: the render thread's)."""
    _local.frame = frame


def set_host_prof(on: bool) -> None:
    """Turn the profiler on (clearing the span log; HOST_PROF keeps what it
    recorded: clear it to start afresh) or off (resolving the device times
    of the log's spans)."""
    global _PROF_ON, _torch, _anchor, _dropped, _unsectioned, _syncs_counted
    if _PROF_ON:
        _PROF_ON = False
        _count_syncs(False)
        _resolve()
    if not on:
        return
    if _torch is None:
        import torch
        _torch = torch
    with _lock:
        _log.clear()
        _frames.clear()
        _sync_sites.clear()
        _dropped = _unsectioned = 0
    cuda = _torch.cuda.is_available() and _torch.cuda.is_initialized()
    if cuda:
        _torch.cuda.synchronize()
        ev = _torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        ev.record()
        ev.synchronize()
        _anchor = (ev, 0.5 * (h0 + time.perf_counter()))
    _syncs_counted = cuda
    _count_syncs(cuda)
    _PROF_ON = True


def _count_syncs(on: bool) -> None:
    """Count PyTorch's flagged synchronising calls (warn mode, every
    occurrence) while on; put the mode and the filters back when off."""
    global _sync_restore
    if on:
        _sync_restore = (_torch.cuda.get_sync_debug_mode(), warnings.showwarning,
                         list(warnings.filters))
        warnings.filterwarnings("always", message=SYNC_WARNING, category=UserWarning)
        warnings.showwarning = _show
        _torch.cuda.set_sync_debug_mode("warn")
    elif _sync_restore is not None:
        mode, show, filters = _sync_restore
        _sync_restore = None
        _torch.cuda.set_sync_debug_mode(mode)
        warnings.showwarning = show
        warnings.filters[:] = filters
        warnings._filters_mutated()


def _show(message, category, filename, lineno, file=None, line=None):
    global _unsectioned
    if SYNC_WARNING not in str(message):
        show = _sync_restore[1] if _sync_restore else warnings._showwarning_orig
        show(message, category, filename, lineno, file, line)
        return
    stack = _stack()
    rec = stack[-1].rec if stack else None
    if rec is not None:
        rec.syncs += 1
    site = (stack[-1].name if stack else None, filename, lineno)
    with _lock:
        _sync_sites[site] = _sync_sites.get(site, 0) + 1
        if rec is None:
            _unsectioned += 1


def _resolve() -> None:
    """Every recorded event onto the host clock, through the anchor."""
    global _anchor
    if _anchor is None:
        return
    anchor, h = _anchor
    _anchor = None
    _torch.cuda.synchronize()
    for rec in _log:
        if rec.ev0 is not None:
            rec.d0 = h + anchor.elapsed_time(rec.ev0) / 1e3
        if rec.ev1 is not None:
            rec.d1 = h + anchor.elapsed_time(rec.ev1) / 1e3
        rec.ev0 = rec.ev1 = None


def _event(device):
    ev = _torch.cuda.Event(enable_timing=True)
    ev.record(_current_stream(device))
    return ev


def _current_stream(device):
    """torch.cuda.current_stream(device), kept while the raw current stream
    is the same one (the lookup costs ~10 us a call on the card's host)."""
    index = _torch.cuda.current_device() if device.index is None else device.index
    raw = _torch._C._cuda_getCurrentRawStream(index)
    hit = _streams.get(index)
    if hit is None or hit[0] != raw:
        hit = _streams[index] = (raw, _torch.cuda.current_stream(index))
    return hit[1]


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def open_sections() -> tuple:
    """The names of the sections open on this thread, outermost first
    (empty while the profiler is off)."""
    return tuple(s.name for s in _stack())


def count_frame(frame, **counts) -> None:
    """File counts under a frame's id (while on)."""
    if _PROF_ON:
        with _lock:
            _frames.setdefault(frame, {}).update(counts)


def add(**counts) -> None:
    """Add counts to the counters of the innermost section open on this
    thread (while on): the merge work of the sort in stage.sort."""
    if _PROF_ON:
        stack = _stack()
        rec = stack[-1].rec if stack else None
        if rec is not None:
            if rec.counters is None:
                rec.counters = {}
            for k, v in counts.items():
                rec.counters[k] = rec.counters.get(k, 0) + v


def annotate(span, **counters) -> None:
    """Set counters on a span (_hprof.span(); None is ignored), also after
    it has closed: the frame that first drew a sort."""
    if span is not None and _PROF_ON:
        if span.counters is None:
            span.counters = {}
        span.counters.update(counters)


def trace() -> Trace:
    """The span log since the profiler was last turned on, as read-only
    records (device times once it has been turned off)."""
    with _lock:
        spans = tuple(
            Span(r.name, r.frame, r.thread, r.parent, r.t0, r.t1, r.self_s,
                 r.d0, r.d1, r.syncs, dict(r.counters or {}))
            for r in _log)
        frames = {k: dict(v) for k, v in _frames.items()}
        return Trace(spans, frames, _dropped, _syncs_counted, _unsectioned,
                     dict(_sync_sites))


class _hprof:
    __slots__ = ("name", "device", "t0", "pre", "child", "rec", "rf")

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device

    def __enter__(self):
        if not _PROF_ON:
            self.t0 = None
            return self
        global _dropped
        self.pre = time.perf_counter()
        self.child = 0.0
        stack = _stack()
        parent = stack[-1].rec if stack else None
        with _lock:
            if len(_log) < LOG_CAP:
                rec = _Rec(len(_log), self.name, current_frame(),
                           threading.get_ident(),
                           None if parent is None else parent.index)
                _log.append(rec)
            else:
                rec = None
                _dropped += 1
        self.rec = rec
        stack.append(self)
        self.rf = None
        if _torch.autograd._profiler_enabled():
            self.rf = _torch.profiler.record_function("gswt." + self.name)
            self.rf.__enter__()
        if (rec is not None and _anchor is not None and self.device is not None
                and self.device.type == "cuda"):
            rec.ev0 = _event(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.t0 is not None:
            t1 = time.perf_counter()
            dt = t1 - self.t0
            rec = self.rec
            if rec is not None:
                if rec.ev0 is not None and _anchor is not None:
                    rec.ev1 = _event(self.device)
                rec.t0, rec.t1, rec.self_s = self.t0, t1, dt - self.child
            if self.rf is not None:
                self.rf.__exit__(None, None, None)
            stack = _stack()
            stack.pop()
            with _lock:
                e = HOST_PROF.setdefault(self.name, [0, 0.0, 0.0])
                e[0] += 1
                e[1] += dt
                e[2] += dt - self.child
            if stack:  # this section with the profiler's work around it
                stack[-1].child += time.perf_counter() - self.pre
        return False

    def span(self):
        """The span this section records (for annotate), or None while the
        profiler is off."""
        return self.rec if self.t0 is not None else None


def host_prof_report() -> str:
    """One line per section, the longest total first, in the JAX package's
    format."""
    lines = []
    for name, (n, s, _) in sorted(HOST_PROF.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{name:24s} n={n:5d} total={s * 1e3:9.1f} ms "
                     f"avg={s / max(n, 1) * 1e3:7.3f} ms")
    return "\n".join(lines)
