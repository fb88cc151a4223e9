from repro_torch.kernels.beam_search.ops import (beam_search,
                                                 beam_search_cuda,
                                                 load_kernel)
from repro_torch.kernels.beam_search.ref import (beam_search_np,
                                                 beam_search_ref)

__all__ = ["beam_search", "beam_search_cuda", "beam_search_np",
           "beam_search_ref", "load_kernel"]
