"""The benchmark of the PyTorch port (``unet_zoo_tpu_torch``) on an NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once. ``harness/`` holds the
traffic generator, the runners of the timed paths, the trace reduction,
the frozen timing helpers and the comparison that decides ``correct``;
``reference/`` the plain PyTorch reference each configuration is held to;
``configs/``, ``workloads/`` and ``metrics/`` the files the harness finds
by name.
"""
