"""Host-section profiler: wall time per named section of the frame loop.

A section is ``with _hprof("name"):``. While the profiler is on
(``set_host_prof(True)``) every section adds to ``HOST_PROF[name] = [n,
total_s, self_s]`` its count, its wall seconds and its self seconds (its
time less that of the sections nested in it on the same thread), to locate
the host work the device does not hide. It reads the host clock and nothing
else: a section never synchronizes the device, so a section around a call
that waits for the device (the ``sync.*`` sections) measures that wait.
Off, the default, a section tests one flag and records nothing.

The frame's sections (``render/pipeline.py``, ``engine/engine.py``,
``ops/binning.py``, ``ops/proxy.py``): ``frame.update_pump``,
``frame.stage``; ``stage.plan``, ``stage.prep`` (on the builder thread when
the Engine has one); ``render.uniforms``, ``render.front.project``,
``.skybox``, ``.proxy``, ``.bin``, ``render.back``, ``render.drain``; and
one ``sync.<where>`` for each call on the frame path that waits for the
device: a read of a device value on the host, or a copy to the device
from pageable host memory, which PyTorch makes synchronous.
"""

from __future__ import annotations

import threading
import time

HOST_PROF: dict = {}
_PROF_ON = False
_lock = threading.Lock()
_local = threading.local()


def set_host_prof(on: bool) -> None:
    """Turn the host-section profiler on or off (HOST_PROF keeps what it
    recorded; clear it to start afresh)."""
    global _PROF_ON
    _PROF_ON = bool(on)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def open_sections() -> tuple:
    """The names of the sections open on this thread, outermost first
    (empty while the profiler is off)."""
    return tuple(s.name for s in _stack())


class _hprof:
    __slots__ = ("name", "t0", "child")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _PROF_ON:
            self.child = 0.0
            _stack().append(self)
            self.t0 = time.perf_counter()
        else:
            self.t0 = None

    def __exit__(self, *exc):
        if self.t0 is not None:
            dt = time.perf_counter() - self.t0
            stack = _stack()
            stack.pop()
            if stack:
                stack[-1].child += dt
            with _lock:
                e = HOST_PROF.setdefault(self.name, [0, 0.0, 0.0])
                e[0] += 1
                e[1] += dt
                e[2] += dt - self.child
        return False


def host_prof_report() -> str:
    """One line per section, the longest total first, in the JAX package's
    format."""
    lines = []
    for name, (n, s, _) in sorted(HOST_PROF.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{name:24s} n={n:5d} total={s * 1e3:9.1f} ms "
                     f"avg={s / max(n, 1) * 1e3:7.3f} ms")
    return "\n".join(lines)
