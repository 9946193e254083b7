"""Engine adapters, one file per configuration `engine`."""
