#!/usr/bin/env python
"""Where the micro-raster kernel's time goes, by builds of its source.

    python -m gswt_renderer_tpu_torch.benchmarks.micro_raster_ab [--rounds 5]

Builds ``csrc/micro_raster.cu`` with nvcc as it is and as probes made by
replacing one piece of it, then times every build in every variant (A, B, C,
C2, D) on ``micro_raster``'s own table (1 << 22 pairs, 1080p, 64x32 tiles,
chunk 256, depth 1):
  as_is       the kernel as it ships;
  no_box      the mask without its box test (every block of every pair
              takes the exact test; the bits are the same);
  setup_only  the mask's set-up, box and candidate list without its exact
              tests: no pair is walked (output not checked);
  mask_only   the walk taken out (staging, every step of the mask, the
              early-exit barriers and the write-out alone; output not
              checked);
  no_mask     no mask: every warp walks every pair (the bits are the same);
  phases      as_is, with thread 0 of every thread block clocking each step
              of a chunk (its share of thread 0's cycles is printed).
Prints each build's registers and spill (ptxas), then per variant the
median, min and max over `rounds` rounds of `--reps` back-to-back calls of
the C entry (CUDA events), the builds taking turns. Every build but
mask_only and setup_only is held bit-equal to as_is first. Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import numpy as np
import torch

from ..ops import kernels
from ..ops.kernels import resolve_device
from . import micro_raster as mr
from .timing import device_label, time_ms

# the pieces of csrc/micro_raster.cu the probes replace
WALK_BALLOT = ("unsigned todo = __ballot_sync(\n"
               "            kFull, jl < j_hi && ((s_mask[jl] >> warp) & 1u));")
SETUP_CALL = "pair_setup<kPrec>(tab, threadIdx.x, u1t, v1t, s_pv, s_box);"
CAND_CALL = "cand = pair_candidates(tab, j, part, s_rect, s_dmax, s_box);"
EXACT_TEST = "if (block_reaches<kPrec>(tab, j, s_pv, s_rect[w]))"
BOX_TEST = ("    if (!(u0 <= xr && u1 >= xl && v0 <= yr && v1 >= yl)) continue;  "
            "// box\n")
# build name -> [(piece, replacement)]
PROBES = {
    "no_box": [(BOX_TEST, "")],
    "setup_only": [(EXACT_TEST, "if (w < 0)")],
    "mask_only": [(WALK_BALLOT, WALK_BALLOT + " aa[0] += __popc(todo); "
                   "todo = 0u;")],
    "no_mask": [(WALK_BALLOT, "unsigned todo = __ballot_sync(kFull, "
                 "jl >= j_lo && jl < j_hi);"), (SETUP_CALL, ";"),
                (CAND_CALL, "cand = 0u;")],
}
UNCHECKED = ("mask_only", "setup_only")  # probes whose output is not kept
# the "phases" build: the kernel as is, with thread 0 of every thread block
# adding the clock cycles of each step of a chunk to g_phase[step]
PHASE_STEPS = ("early exit (waits for every warp's walk)", "staging wait",
               "set-up and packing", "candidates", "exact tests",
               "thread 0's own walk")
_PH = ("if (threadIdx.x == 0) {{ const long long t_n = clock64(); "
       "atomicAdd(&g_phase[{}], (unsigned long long)(t_n - t_ph)); "
       "t_ph = t_n; }}\n")
PHASE_PIECES = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n"
     "__device__ unsigned long long g_phase[8];\n"),
    ("    bool drained = true;\n",
     "    bool drained = true;\n    long long t_ph = clock64();\n"),
    ("      // the next chunk into the other stage, last read before the",
     _PH.format(0) + "      // the next chunk into the other stage, last "
     "read before the"),
    ("      const float(*tab)[kMaxChunk] = s_tab[st];\n",
     "      const float(*tab)[kMaxChunk] = s_tab[st];\n" + _PH.format(1)),
    ("      __syncthreads();\n      // the candidates",
     "      __syncthreads();\n" + _PH.format(2) + "      // the candidates"),
    ("      __syncthreads();\n      // the exact test",
     "      __syncthreads();\n" + _PH.format(3) + "      // the exact test"),
    ("      __syncthreads();\n\n      // this warp's pairs",
     "      __syncthreads();\n" + _PH.format(4) + "      // this warp's pairs"),
    ("    }\n    // a chunk staged for a tile that stopped early",
     _PH.format(5) + "    }\n    // a chunk staged for a tile that stopped "
     "early"),
]
PHASE_ENTRY = """
extern "C" int gswt_micro_raster_phases(void* host, int reset) {
  if (reset) {
    const unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
}
"""


def sources() -> dict:
    """{build name: CUDA source}: the kernel as is and its probes."""
    with open(os.path.join(kernels.CSRC, "micro_raster.cu")) as f:
        src = f.read()
    out = {"as_is": src}
    for name, pieces in PROBES.items():
        probe = src
        for old, new in pieces:
            if probe.count(old) != 1:
                raise RuntimeError(f"micro_raster.cu no longer holds the "
                                   f"piece the {name} probe replaces")
            probe = probe.replace(old, new)
        out[name] = probe
    probe = src
    for old, new in PHASE_PIECES:
        if probe.count(old) != 1:
            raise RuntimeError("micro_raster.cu no longer holds a piece the "
                               "phases build instruments")
        probe = probe.replace(old, new)
    out["phases"] = probe + PHASE_ENTRY
    return out


def _build(srcs: dict) -> dict:
    """{name: (C entry gswt_micro_raster, ptxas report, the phases build's
    counter entry or None)}, nvcc at once."""
    os.makedirs(kernels.BUILD, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        cu = os.path.join(kernels.BUILD, f"micro_raster_ab_{name}.cu")
        so = os.path.join(kernels.BUILD, f"libmicro_raster_ab_{name}.so")
        with open(cu, "w") as f:
            f.write(src)
        cmd = kernels._compile_cmd("micro_raster", so)
        cmd[-1] = cu
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(so)
        fn = lib.gswt_micro_raster
        fn.argtypes = [vp, ll, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                       vp]
        fn.restype = ci
        phases = None
        if name == "phases":
            phases = lib.gswt_micro_raster_phases
            phases.argtypes = [vp, ci]
            phases.restype = ci
        built[name] = (fn, out, phases)
    return built


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(f"[micro_raster_ab] {device_label(dev)}")
    built = _build(sources())
    for name, (_, report, _) in built.items():
        for inst, text in sorted(mr.ptxas_by_variant(report).items()):
            print(f"[micro_raster_ab] build {name} <kLocal, kPrec, kBf2> = "
                  f"{inst}: {text}")

    image_wh, tile_wh, chunk = (1920, 1080), (64, 32), 256
    ntx, _, n_tiles = mr._grid(image_wh, tile_wh)
    binned = mr.make_binned(1 << 22, image_wh, tile_wh, device=dev)
    depth = torch.ones((n_tiles, tile_wh[0] * tile_wh[1]), device=dev)
    out = {n: torch.empty((n_tiles, 4, tile_wh[0] * tile_wh[1]), device=dev)
           for n in built}
    result = {}
    for var, (local, prec, bf2, _) in mr.VARIANTS.items():
        b, _ = mr.variant_inputs(binned, var, image_wh=image_wh,
                                 tile_wh=tile_wh)
        table = b["table"]

        def call(name):
            rc = built[name][0](
                table.data_ptr(), table.shape[1],
                b["range_start"].data_ptr(), b["range_end"].data_ptr(),
                depth.data_ptr(), out[name].data_ptr(), n_tiles, ntx,
                tile_wh[0], tile_wh[1], chunk, int(local),
                mr.PRECISIONS.index(prec), int(bf2), kernels.stream_ptr(table))
            kernels.check(rc, f"micro_raster {name}")

        for name in built:
            call(name)
        torch.cuda.synchronize()
        for name in built:
            if name not in UNCHECKED and not torch.equal(out[name],
                                                       out["as_is"]):
                raise RuntimeError(f"micro_raster {var}: build {name} is not "
                                   f"bit-equal to as_is")
        ms = {n: [] for n in built}
        for k in range(args.rounds):
            for n in (sorted(built) if k % 2 == 0
                      else sorted(built, reverse=True)):
                ms[n].append(time_ms(lambda: call(n), args.reps, dev))
        result[var] = {n: float(np.median(x)) for n, x in ms.items()}
        for n, x in ms.items():
            x = np.array(x)
            print(f"[micro_raster_ab] {var} {n}: median {np.median(x):.4f} "
                  f"ms (min {x.min():.4f}, max {x.max():.4f})")
        # one call of the phases build: thread 0's cycles per step
        counters = built["phases"][2]
        cyc = (ctypes.c_ulonglong * 8)()
        torch.cuda.synchronize()
        kernels.check(counters(None, 1), "micro_raster phases")
        call("phases")
        torch.cuda.synchronize()
        kernels.check(counters(ctypes.cast(cyc, ctypes.c_void_p), 0),
                      "micro_raster phases")
        total = sum(cyc[:len(PHASE_STEPS)])
        result[var]["phases"] = {st: cyc[i] / total
                                 for i, st in enumerate(PHASE_STEPS)}
        print(f"[micro_raster_ab] {var} thread 0's cycles by step of a chunk "
              f"(summed over thread blocks): " + ", ".join(
                  f"{st} {cyc[i] / total:.3f}"
                  for i, st in enumerate(PHASE_STEPS)))
    return result


if __name__ == "__main__":
    main()
