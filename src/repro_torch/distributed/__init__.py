"""Host-side fault tolerance of the PyTorch port (:mod:`fault_tolerance`)."""
