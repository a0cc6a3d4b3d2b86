"""Benchmarks of the port: the headline fly-through (``headline``), the
parked sorted merge (``mergesorted``), the micro-benchmarks that A/B a
kernel against plain PyTorch (``micro_merge``, ``micro_raster``,
``micro_blockgather``), the camera batch and stream segments against the
interactive frame (``batched_ab``) and the tile-shape sweep
(``sweep_shapes``). Each script runs on the card unless given
``--device cpu``."""
