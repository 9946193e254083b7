"""The plain PyTorch reference of the bit-sliced index: imports nothing of
the program."""
