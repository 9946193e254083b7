"""idl_probe of the PyTorch port."""
