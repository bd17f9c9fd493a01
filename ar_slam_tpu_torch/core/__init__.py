"""core of the PyTorch port (see ar_slam_tpu/core for the reference)."""
