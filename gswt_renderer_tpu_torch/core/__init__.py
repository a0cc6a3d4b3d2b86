from .mathutil import (
    look_at_rh,
    perspective,
    normalize,
    vp_z_row,
    OPENGL_TO_WGPU,
)
from .metrics import IncrementalMA, Timer
from .camera import Camera, CameraUniforms
from .config import (
    UserData,
    RenderConfig,
    SurfaceType,
    HeightMapType,
    TileSortType,
    SelectiveMergeType,
    DrawMode,
)
