"""Configurations: the index's ``PyramidConfig`` and the language
model's ``ArchConfig`` (copies of ``repro.common.config``).

Everything is a frozen dataclass. An ``ArchConfig`` describes the
transformer backbone as published; ``reduced()`` derives the small
same-family variant the CPU tests run.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class BlockKind(str, enum.Enum):
    """Layer-block kinds a model stack can interleave."""

    ATTENTION = "attention"
    MAMBA2 = "mamba2"
    SHARED_ATTENTION = "shared_attention"  # zamba2: weight-tied attention block


class AttentionKind(str, enum.Enum):
    FULL = "full"
    SLIDING = "sliding"           # sliding-window attention (SWA)
    LOCAL_GLOBAL = "local_global"  # gemma3: ratio of local SWA to global layers


class RoPEKind(str, enum.Enum):
    NONE = "none"
    STANDARD = "standard"
    TWO_D = "2d"  # chatglm3: rotary applied to half the head dim


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    # capacity factor for dense one-hot dispatch; tokens beyond capacity drop
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""

    state_dim: int = 128          # N: per-head SSM state size
    head_dim: int = 64            # P: channels per SSM head
    expand: int = 2               # d_inner = expand * d_model
    chunk_size: int = 256         # SSD chunk length (matmul-friendly)
    conv_width: int = 4           # causal depthwise conv width


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture.

    ``block_pattern`` describes one period of the layer stack; it is tiled to
    ``num_layers``. Dense models are just ``(ATTENTION,)``.
    """

    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    block_pattern: Tuple[BlockKind, ...] = (BlockKind.ATTENTION,)
    attention_kind: AttentionKind = AttentionKind.FULL
    sliding_window: int = 4096              # for SWA kinds
    local_to_global_ratio: int = 0          # gemma3: 5 local per 1 global
    rope: RoPEKind = RoPEKind.STANDARD
    rope_theta: float = 10_000.0
    qk_norm: bool = False                   # qwen3
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    tie_embeddings: bool = False
    # Modality frontend stub: if set, inputs are precomputed embeddings of
    # shape [batch, seq, frontend_dim] instead of token ids.
    frontend: Optional[str] = None          # None | "vision" | "audio"
    frontend_dim: int = 0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    source: str = ""                        # citation bracket from assignment

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        if self.num_heads == 0:
            return 0
        return self.d_model // self.num_heads

    def layer_kinds(self) -> Tuple[BlockKind, ...]:
        """The full, tiled layer stack (length == num_layers)."""
        reps = -(-self.num_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.num_layers]

    def reduced(self) -> "ArchConfig":
        """A tiny same-family variant for CPU smoke tests."""
        d_model = min(self.d_model, 128)
        heads = min(self.num_heads, 4) if self.num_heads else 0
        kv = max(1, min(self.num_kv_heads, heads)) if heads else 0
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=min(4, self.moe.num_experts),
                experts_per_token=min(2, self.moe.experts_per_token))
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, chunk_size=32)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=2,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=(d_model // heads) if heads else None,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 64),
            moe=moe,
            ssm=ssm,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend else 0,
            dtype="float32",
        )

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # token embedding
        if not self.tie_embeddings:
            total += v * d  # lm head
        hd = self.resolved_head_dim
        for kind in self.layer_kinds():
            if kind in (BlockKind.ATTENTION, BlockKind.SHARED_ATTENTION):
                q = d * self.num_heads * hd
                kv = 2 * d * self.num_kv_heads * hd
                o = self.num_heads * hd * d
                attn = q + kv + o
                if self.moe is not None:
                    mlp = self.moe.num_experts * 3 * d * self.d_ff
                    mlp += d * self.moe.num_experts  # router
                else:
                    mlp = 3 * d * self.d_ff
                total += attn + mlp + 2 * d  # two RMSNorm scales
            elif kind == BlockKind.MAMBA2:
                s = self.ssm or SSMConfig()
                d_in = s.expand * d
                nheads = d_in // s.head_dim
                total += d * (2 * d_in + 2 * nheads * s.state_dim)  # in_proj-ish
                total += d_in * d  # out_proj
                total += 2 * nheads + d  # A, dt bias, norm
        return total


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Configuration of the paper's index (Alg. 3 / Alg. 5)."""

    metric: str = "l2"            # l2 | ip | angular
    num_shards: int = 16          # w: number of sub-HNSWs
    meta_size: int = 1_000        # m: k-means centers / meta-HNSW vertices
    sample_size: int = 20_000     # n': sample for k-means
    branching_factor: int = 4     # K: meta neighbours used for routing
    # HNSW parameters (paper defaults: M=32 bottom, 16 upper, ef=100)
    max_degree: int = 32
    max_degree_upper: int = 16
    ef_construction: int = 100
    ef_search: int = 100
    # MIPS norm-replication (Alg. 5)
    replication_r: int = 0        # r: top-r MIPS neighbours per meta vertex
    # capacity factor for distributed dispatch (queries per shard slot)
    capacity_factor: float = 2.0
    kmeans_iters: int = 12
    seed: int = 0

    @property
    def is_mips(self) -> bool:
        return self.metric == "ip"
