from repro_torch.kernels.quant_distance.ops import (quant_impl, quant_scores,
                                                    quant_scores_cuda)
from repro_torch.kernels.quant_distance.ref import (dequantize,
                                                    quant_scores_np,
                                                    quant_scores_ref)

__all__ = ["dequantize", "quant_impl", "quant_scores", "quant_scores_cuda",
           "quant_scores_np", "quant_scores_ref"]
