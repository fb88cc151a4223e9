from repro_torch.kernels.merge_topk.ops import merge_topk, merge_topk_cuda
from repro_torch.kernels.merge_topk.ref import merge_topk_np, merge_topk_ref

__all__ = ["merge_topk", "merge_topk_cuda", "merge_topk_np",
           "merge_topk_ref"]
