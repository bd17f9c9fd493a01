"""solve of the PyTorch port (see ar_slam_tpu/solve for the reference)."""
