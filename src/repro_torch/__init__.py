"""PyTorch + CUDA port of the FastGRNN serving system.

Mirrors the module paths of the reference JAX package ``repro`` one for
one (``core/``, ``compress/``, ``configs/``, ``models/``,
``kernels/fastgrnn_cell/``, ``kernels/lut_act/``, ``kernels/q15_matmul/``,
``serve/``, ``obs/``, ``data/``) so a reader can find each counterpart.  It imports ``torch`` and numpy only: never
``jax`` and never anything from ``repro``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; asking for ``"cuda"`` without a card raises (see
:func:`repro_torch.device.resolve_device`).  The hand-written kernels live
in ``csrc/`` (the Q15 step, its dense layout, the fused window scan,
the LUT activation and the quantized matmul of the LM engine's head) and
are built at first use by
:mod:`repro_torch.kernels._build`.
"""
