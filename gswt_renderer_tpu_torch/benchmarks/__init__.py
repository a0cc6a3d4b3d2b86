"""Benchmarks of the port: the headline fly-through (``headline``), the
parked sorted merge (``mergesorted``) and the micro-benchmarks that A/B a
kernel against plain PyTorch (``micro_merge``, ``micro_raster``,
``micro_blockgather``). Each script runs on the card unless given
``--device cpu``."""
