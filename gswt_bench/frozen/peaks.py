"""Published H100 peaks and the compositor's bound arithmetic.

Frozen copy, at commit 6240227d, of ``chip_smoke.py``'s constants
(``HBM_BYTES_PER_S``, ``FP32_OPS_PER_S``, ``SFU_OPS_PER_S``,
``RASTER_FAST_FP32_OPS``, ``RASTER_ROWS``) and of the arithmetic of its
``raster_kept_bound``: the work on the kept pair-pixels, the input rows read
once, the depth read once and the output written once; the bound is the
largest of the FP32, SFU and byte terms. Peaks: NVIDIA's H100 SXM data sheet
(non-tensor FP32, HBM3); the SFU rate from the Hopper white paper (132 SMs x
16 transcendental results per clock x 1.98 GHz boost).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
# per kept pair-pixel: 22 FP32 operations and one exp in the compositor's
# loop, plus the fast variant's round of the weight to bf16 and back (2)
RASTER_FAST_FP32_OPS = 24
# float32 words of one composited splat's table row
RASTER_ROWS = 11
# early-exit transmittance of the compositor (ops/raster.py MIN_T): a
# pixel behind T < MIN_T needs no further work
MIN_T = 0.5 / 255.0


def raster_bound_s(kept: int, rows: int, pixels: int, use_depth: bool,
                   ops: int = RASTER_FAST_FP32_OPS) -> tuple:
    """(seconds, bound_by): the least time the card needs to composite
    `kept` pair-pixels whose splats' `rows` table rows are read once, over
    `pixels` output pixels (RGBA float32 written once; the depth read once
    when depth-tested)."""
    n_bytes = 4 * (rows * RASTER_ROWS + pixels * 4
                   + (pixels if use_depth else 0))
    terms = dict(operations=kept * ops / FP32_OPS_PER_S,
                 sfu=kept / SFU_OPS_PER_S,
                 bytes=n_bytes / HBM_BYTES_PER_S)
    by = max(terms, key=terms.get)
    return terms[by], by
