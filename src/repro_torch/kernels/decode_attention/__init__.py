from repro_torch.kernels.decode_attention.ops import (flash_decode,
                                                      flash_decode_cuda,
                                                      load_kernel)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

__all__ = ["decode_attention_ref", "flash_decode", "flash_decode_cuda",
           "load_kernel"]
