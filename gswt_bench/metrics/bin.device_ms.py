"""bin.device_ms: the mean over the window's frames of the device time of the
section render.front.bin (binning: pair expansion, sort and scatter): from
its entry event to its exit event on the frame's stream, placed on the host
clock by the program's span log (core/hostprof.py trace()). It includes any
idle time inside the section: it is the stage's busy time only where the
device runs behind the host by more than the section's host time
(host.lead_ms), as in the device-bound cell that lists it. A host-bound
cell, where the span holds mostly the device waiting for the host's
launches, does not list it. Nothing without a card or in a program without
the span log."""

from gswt_bench.spanlog import device_ms


def read(ctx):
    return device_ms("render.front.bin")
