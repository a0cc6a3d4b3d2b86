"""The program's span log (gswt_renderer_tpu_torch/core/hostprof.py
trace()) as the per-layer metrics in metrics/ read it: on for the whole
traced window, device times on the host clock through one anchor event."""


def trace():
    """The span log, or None in a program that has none."""
    try:
        from gswt_renderer_tpu_torch.core import hostprof
    except ImportError:
        return None
    return hostprof.trace() if hasattr(hostprof, "trace") else None


def device_ms(section):
    """The mean over the window's frames of the device time of `section`
    (its exit event less its entry event, summed over the frame's spans
    of it), in ms; None without device times."""
    tr = trace()
    per_frame = {}
    for s in tr.spans if tr is not None else ():
        if s.name == section and s.device_start is not None and s.device_end is not None:
            per_frame[s.frame] = per_frame.get(s.frame, 0.0) + s.device_end - s.device_start
    if not per_frame:
        return None
    return sum(per_frame.values()) / len(per_frame) * 1e3
