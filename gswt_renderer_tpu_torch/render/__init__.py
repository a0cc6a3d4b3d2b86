from .uniforms import SceneParams, FrameInputs, build_frame_inputs
