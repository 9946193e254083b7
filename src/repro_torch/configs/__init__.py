"""configs of the PyTorch port."""
