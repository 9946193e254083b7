"""Loops that drive the program, one file per traffic mix `kind`."""
