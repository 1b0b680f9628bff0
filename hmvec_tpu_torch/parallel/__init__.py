"""Multi-device layer of the PyTorch port (port of hmvec_tpu/parallel)."""
