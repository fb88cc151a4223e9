"""Hand-written Hopper kernels of the port and their launch counters.

Each kernel's wrapper (``*_cuda`` in its ``ops`` module) carries a plain
integer ``launches`` that it raises by one each time it launches its
kernel; :func:`launch_counts` and :func:`reset_launch_counts` read and
clear them, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Dict


def _wrappers():
    from repro_torch.kernels.beam_search.ops import beam_search_cuda
    from repro_torch.kernels.decode_attention.ops import flash_decode_cuda
    from repro_torch.kernels.merge_topk.ops import merge_topk_cuda
    from repro_torch.kernels.quant_distance.ops import quant_scores_cuda
    from repro_torch.kernels.ssd.ops import ssd_backward_cuda, ssd_cuda
    from repro_torch.kernels.topk_distance.ops import topk_similarity_cuda
    return {"beam_search": beam_search_cuda,
            "merge_topk": merge_topk_cuda,
            "topk_distance": topk_similarity_cuda,
            "quant_distance": quant_scores_cuda,
            "decode_attention": flash_decode_cuda,
            "ssd": ssd_cuda,
            "ssd_backward": ssd_backward_cuda}


def launch_counts() -> Dict[str, int]:
    return {name: int(fn.launches) for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
