"""detect of the PyTorch port (see ar_slam_tpu/detect for the reference)."""
