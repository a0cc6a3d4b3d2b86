"""The benchmark of gswt_renderer_tpu_torch: BENCHMARK.json's harness.

``run.py`` runs one cell once. ``configs/``, ``traffic/``, ``metrics/`` and
``limits/`` hold one file per configuration, traffic mix, metric and cell,
found by name. ``frozen/`` holds the copies that make the yardstick and
``reference/`` the plain reference that decides ``correct``.
"""
