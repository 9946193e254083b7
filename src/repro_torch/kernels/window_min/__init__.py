"""window_min of the PyTorch port."""
