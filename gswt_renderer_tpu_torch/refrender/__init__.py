"""The golden oracle on torch tensors: a slow, literal transcription of the
reference's WGSL vertex and fragment math and of its back-to-front blend,
independent of the pipeline's own (``oracle.py``)."""

from .oracle import (assemble_stream, assemble_stream_np, project_draw,
                     project_draw_np, render_oracle)
