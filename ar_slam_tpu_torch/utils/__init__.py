"""utils of the PyTorch port (see ar_slam_tpu/utils for the reference)."""
