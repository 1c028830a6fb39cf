"""repro_torch.deploy — MCU export compiler + pure-integer Q15 emulator,
ported from the reference ``repro.deploy``.

The paper's headline contribution is the *deployment* half: a 566-byte
weight image running bit-equivalently on an 8-bit AVR and a multiplier-less
MSP430.  This package ships that artifact:

  * :mod:`.image`   — pack a calibrated ``ModelArtifact`` (quantized
    params + activation scales) and both 256-entry LUTs into a
    deterministic, versioned, size-audited weight image (``.fgrn``),
    byte-identical to the reference's;
  * :mod:`.qvm`     — a pure-integer Q15 virtual machine (int16 storage,
    wide accumulators, explicit shifts/saturation, zero float ops in the
    hot loop) executing the packed image on host — the stand-in for the
    multiplier-less MSP430 path;
  * :mod:`.emit_c`  — a C code generator lowering the image into a
    self-contained ``fastgrnn_model.h`` / ``fastgrnn_cell.c``
    translation unit for ``avr`` / ``msp430`` / ``host`` targets (no libm
    in the LUT path), plus a host build-and-drive harness;
  * :mod:`.goldens` — golden-trace generation (per-step hidden states +
    final argmax);
  * :mod:`.verify`  — the parity harness reproducing the paper's
    3,399-window 100%-agreement protocol across FP32 / QRuntime /
    StreamingEngine (the step kernel K1 on the card) / qvm / compiled C.

Everything here is NumPy and host C except the engine and the fp32 path
of :func:`run_parity`, which run on its ``device``.
"""
from .image import (DeployImage, build_image, export_model, size_report,
                    audit_platforms, ACT_KEYS, IMAGE_VERSION)
from .qvm import QVM, QuantPlan, Requant, quantize_multiplier
from .emit_c import generate_sources, write_sources, compile_host, CHostModel
from .goldens import (build_reference_artifact, build_reference_model,
                      generate_goldens, save_goldens, load_goldens)
from .verify import run_parity

__all__ = [
    "DeployImage", "build_image", "export_model", "size_report",
    "audit_platforms", "ACT_KEYS", "IMAGE_VERSION",
    "QVM", "QuantPlan", "Requant", "quantize_multiplier",
    "generate_sources", "write_sources", "compile_host", "CHostModel",
    "build_reference_artifact", "build_reference_model", "generate_goldens",
    "save_goldens", "load_goldens",
    "run_parity",
]
