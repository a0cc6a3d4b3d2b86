"""gswt_renderer_tpu_torch — the GSWT renderer in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``gswt_renderer_tpu`` is the reference; this package mirrors
its layout so each counterpart sits at the same path:

- ``core``, ``io``, ``native``, ``tiles``, ``engine.control``,
  ``render.uniforms``  framework-neutral host code, kept as own copies
- ``ops``       projection, binning and the compositor on torch tensors; the
                Pallas kernels become CUDA kernels under ``csrc/``
                (``ops.blockgather``, ``ops.raster``), each beside a plain
                PyTorch version of the same function
- ``render``    the per-frame pipeline (``Renderer``)
- ``engine``    the session loop with its async builder thread (``Engine``)

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; on a CPU tensor every kernel wrapper runs its plain version.
This package imports neither ``jax`` nor ``gswt_renderer_tpu``.

Ported so far: the gs-only frame (no skybox, no proxy) in the exact profile.
"""

__version__ = "0.1.0"
