from repro_torch.kernels.ssd.ops import (SSD_BWD_TOL, SSD_BWD_TOL_BF16,
                                        SSDScan, load_kernel,
                                        ssd_backward_cuda, ssd_cuda,
                                        ssd_scan)
from repro_torch.kernels.ssd.ref import ssd_backward_ref, ssd_ref

__all__ = ["SSDScan", "SSD_BWD_TOL", "SSD_BWD_TOL_BF16", "load_kernel",
           "ssd_backward_cuda", "ssd_backward_ref", "ssd_cuda", "ssd_ref",
           "ssd_scan"]
