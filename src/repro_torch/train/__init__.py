"""LM training (reference ``repro.train``): the Adam optimizer and IHT
masks, checkpoints in the reference's on-disk format (resharded across
meshes), the straggler monitor and the fault-tolerant trainer, gradient
compression with error feedback, and GPipe pipelining."""
