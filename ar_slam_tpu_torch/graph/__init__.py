"""graph of the PyTorch port (see ar_slam_tpu/graph for the reference)."""
