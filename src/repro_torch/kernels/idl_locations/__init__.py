"""idl_locations of the PyTorch port: the fused location kernels."""
