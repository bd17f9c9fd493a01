"""viz of the PyTorch port (see ar_slam_tpu/viz for the reference)."""
