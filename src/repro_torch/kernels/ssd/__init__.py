from repro_torch.kernels.ssd.ops import ssd_cuda, ssd_scan
from repro_torch.kernels.ssd.ref import ssd_ref

__all__ = ["ssd_cuda", "ssd_ref", "ssd_scan"]
