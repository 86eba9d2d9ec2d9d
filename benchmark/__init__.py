"""The benchmark of the PyTorch/CUDA port (``praline_tpu_torch``) on one H100.

``run.py`` runs one cell once; ``harness.py`` drives it; ``families.py``
makes the traffic; ``reference/`` decides ``correct``; ``roofline.py`` and
``tracing.py`` hold the yardstick the per-layer metrics (``metrics/``) read.
Nothing here imports JAX or the JAX package.
"""
