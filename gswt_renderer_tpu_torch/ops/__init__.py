from .project import assemble_and_project, cull_draws, pack_draw_bits
from .binning import bin_pairs
from .blockgather import block_gather, block_gather_plain
from .raster import rasterize, rasterize_plain
