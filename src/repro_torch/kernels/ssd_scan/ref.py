"""Oracle of the SSD scan kernel (reference ``repro.kernels.ssd_scan.ref``):
the model's own chunked scan, ``models.mamba2.ssd_chunked``."""
from repro_torch.models.mamba2 import ssd_chunked as ssd_scan_ref  # noqa: F401
