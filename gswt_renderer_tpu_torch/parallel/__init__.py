from .batched import (
    make_mesh,
    render_cameras_sharded,
    render_stream_sharded,
    render_stream_segments,
    composite_over,
)
