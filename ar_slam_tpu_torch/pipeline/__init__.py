"""pipeline of the PyTorch port (see ar_slam_tpu/pipeline for the reference)."""
