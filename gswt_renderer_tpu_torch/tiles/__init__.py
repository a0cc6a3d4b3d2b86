from .structures import (
    DrawTable,
    TileBaseData,
    SceneData,
    RenderDataKey,
    RenderDataValue,
    MergeStatus,
    TransitionStatus,
)
from .wangtile import WangTileEngine
