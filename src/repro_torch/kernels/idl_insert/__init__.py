"""idl_insert of the PyTorch port."""
