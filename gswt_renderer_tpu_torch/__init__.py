"""gswt_renderer_tpu_torch — the GSWT renderer in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``gswt_renderer_tpu`` is the reference; this package mirrors
its layout so each counterpart sits at the same path:

- ``core``, ``io``, ``native``, ``tiles``, ``engine.control``,
  ``render.uniforms``  framework-neutral host code, kept as own copies
- ``ops``       projection, skybox, proxy ground, binning and the compositor
                on torch tensors; the Pallas kernels become CUDA kernels
                under ``csrc/`` (``ops.blockgather``, ``ops.raster``,
                ``ops.trirast``, ``ops.texsample``), and projection is one
                (``ops.project``), each beside a plain PyTorch version of
                the same function
- ``render``    the per-frame pipeline (``Renderer``)
- ``engine``    the session loop with its async builder thread (``Engine``)
- ``parallel``  camera- and stream-parallel rendering over torch.distributed
- ``viewer``    the CLI, headless fly-path frames and the HTTP viewer
- ``refrender`` the golden oracle: a slow, literal transcription of the
                reference's WGSL math on torch tensors, on the card or the
                CPU, independent of ``ops``
- ``benchmarks`` the headline fly-through and the A/B scripts

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; on a CPU tensor every kernel wrapper runs its plain version.
This package imports neither ``jax`` nor ``gswt_renderer_tpu``.

Ported so far: the full-config frame (skybox + proxy ground + splats) in both
profiles, the default fast profile (``RendererConfig.exact=False``, with the
optional ``sat_cull`` and ``depth_cull``) and the exact one, the bench entry,
the viewer, the parallel paths and the oracle.
"""

__version__ = "0.1.0"
