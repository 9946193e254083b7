"""Neural-network substrates of the PyTorch port: the LM family's building
blocks (:mod:`layers`), routed experts (:mod:`moe`), the decoder-only
transformer with its serving path and training loss (:mod:`transformer`)
and the carry-over of the reference's weights and train states
(:mod:`convert`)."""
