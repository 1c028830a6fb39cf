"""LM training on one device (reference ``repro.train``): the Adam
optimizer and IHT masks, checkpoints in the reference's on-disk format,
the straggler monitor and the fault-tolerant trainer."""
