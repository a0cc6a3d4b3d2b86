from .headless import write_png, render_flypath_frames
