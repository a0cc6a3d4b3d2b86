from .ply import (
    SH_C0,
    parse_ply_header,
    load_ply,
    load_splat_bytes,
    pack_splats,
    Scene,
)
from .zipload import load_scene_zip, load_scene_dir
from .synth import make_synthetic_tile_set, write_ply, write_tile_zip
