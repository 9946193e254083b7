"""Training of the PyTorch port: the optimizers (:mod:`optimizer`), the
train state and step (:mod:`train_state`), checkpoints in the reference's
on-disk format (:mod:`checkpoint`) and the fault-tolerant loop
(:mod:`loop`)."""
