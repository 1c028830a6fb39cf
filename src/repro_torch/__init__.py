"""PyTorch + CUDA port of the FastGRNN serving system.

Mirrors the module paths of the reference JAX package ``repro`` one for
one (``core/``, ``compress/``, ``kernels/fastgrnn_cell/``, ``serve/``,
``obs/``, ``data/``) so a reader can find each counterpart.  It imports
``torch`` and numpy only: never ``jax`` and never anything from ``repro``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; asking for ``"cuda"`` without a card raises (see
:func:`repro_torch.device.resolve_device`).  The one hand-written kernel of
the serving path lives in ``csrc/q15_step.cu`` and is built at first use
by :mod:`repro_torch.kernels._build`.
"""
