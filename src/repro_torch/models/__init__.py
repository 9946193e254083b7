"""Neural-network substrates of the PyTorch port: the LM family's building
blocks (:mod:`layers`), routed experts (:mod:`moe`), the decoder-only
transformer with its serving path and training loss (:mod:`transformer`),
the recsys zoo with its IDL row hashing (:mod:`recsys`), the EquiformerV2
GNN (:mod:`equiformer`, over :mod:`so3` and :mod:`gnn_common`) and the
carry-over of the reference's weights and train states (:mod:`convert`)."""
