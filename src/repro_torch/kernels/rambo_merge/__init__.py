"""rambo_merge of the PyTorch port."""
