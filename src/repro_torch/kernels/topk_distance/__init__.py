from repro_torch.kernels.topk_distance.ops import (topk_similarity,
                                                   topk_similarity_cuda)
from repro_torch.kernels.topk_distance.ref import topk_similarity_ref

__all__ = ["topk_similarity", "topk_similarity_cuda", "topk_similarity_ref"]
