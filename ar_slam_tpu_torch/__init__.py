"""ar_slam_tpu_torch — the AR-tag SLAM engine on PyTorch and CUDA.

A port of ``ar_slam_tpu`` (JAX/XLA/Pallas) that keeps its module layout:

- ``core``     — axis-angle algebra, projection, pose seeding
- ``graph``    — host-side constraint-graph store + map.yaml IO (copies)
- ``solve``    — Levenberg–Marquardt with grouped dense Schur elimination
- ``detect``   — batched Aruco detection around hand-written CUDA kernels
                 (``csrc/``: box filter, connected components, extreme
                 points), each with a plain PyTorch version beside it
- ``pipeline`` — image ingest + the mapping engine

The port imports ``torch`` and never ``jax``.  This file imports nothing
heavy so the command-line entry point starts fast.
"""

__version__ = "0.1.0"
