from repro_torch.kernels.quant_distance.ref import (dequantize, quant_scores,
                                                    quant_scores_np)

__all__ = ["dequantize", "quant_scores", "quant_scores_np"]
