"""Distribution of the PyTorch port: host-side fault tolerance
(:mod:`fault_tolerance`), int8 gradient compression (:mod:`collectives`)
and logical-axis sharding rules over ``DeviceMesh`` (:mod:`sharding`)."""
