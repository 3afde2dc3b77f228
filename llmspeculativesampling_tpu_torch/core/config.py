"""Model configuration (counterpart of ``llmspeculativesampling_tpu/core/config.py``).

Same fields as the JAX ``LlamaConfig`` and ``OPTConfig``; ``torch_dtype``
replaces ``jnp_dtype``. Also holds :func:`resolve_device`, the one place that turns
a ``device`` argument into a ``torch.device``: the default is the CUDA card,
and a missing card is an error, never a silent CPU fallback.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. Raises when CUDA is requested (or
    defaulted to) and absent; ``device="cpu"`` must be asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point runs on the GPU by "
            "default; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (host timers end here); a no-op on
    the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Decoder-only Llama family (llama-68m/160m/2-7b/2-13b...)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_position: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # None or ("linear"|"dynamic", factor)
    rope_scaling: Optional[tuple] = None
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # flash-decode attention kernel: "auto" (short new blocks), "on"
    # (same as auto: the kernel covers every s_new <= 32), "off" (always
    # the einsum path)
    flash: str = "auto"
    qkv_bias: bool = False
    # the decoder implements full attention only (it ignores the window);
    # ModelBundle.make_cache rejects caches larger than the window
    sliding_window: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    """Decoder-only OPT family (opt-125m...opt-13b): learned positions with
    the +2 offset, pre- or post-LayerNorm, ReLU MLP, biases on every
    projection, optional word-embed projections (opt-350m), tied head."""

    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position: int = 2048
    word_embed_proj_dim: Optional[int] = None  # != hidden_size only for 350m
    do_layer_norm_before: bool = True
    layer_norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    flash: str = "auto"  # see LlamaConfig.flash

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_kv_heads(self) -> int:
        return self.num_heads

    @property
    def embed_dim(self) -> int:
        return self.word_embed_proj_dim or self.hidden_size

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


MELLUM_LAYER_TYPES = (("sliding_attention",) * 3 + ("full_attention",)) * 7


@dataclasses.dataclass(frozen=True)
class MellumConfig:
    """Mellum 2 decoder (JetBrains' ``model_type`` "mellum", e.g.
    Mellum2-12B-A2.5B): RMSNorm, GQA with a ``head_dim`` of its own (the
    query width ``num_heads * head_dim`` need not be the hidden size),
    ``layer_types`` mixing window layers (the last ``sliding_window``
    positions, plain RoPE) and full layers (YaRN RoPE, ``yarn``), and a
    routed SiLU-gated expert MLP in every layer (``models/moe.py``). With
    ``num_experts`` 0 every MLP is one dense SwiGLU of
    ``intermediate_size`` (the benchmark's draft)."""

    vocab_size: int = 98304
    hidden_size: int = 2304
    intermediate_size: int = 7168
    moe_intermediate_size: int = 896
    num_layers: int = 28
    num_heads: int = 32
    num_kv_heads: int = 4
    head_dim: int = 128
    num_experts: int = 64
    num_experts_per_tok: int = 8
    norm_topk_prob: bool = True
    layer_types: tuple = MELLUM_LAYER_TYPES
    sliding_window: int = 1024
    rope_theta: float = 500000.0  # both kinds of layer
    # the full layers' rope: ("yarn", factor, original_max_position_embeddings,
    # beta_fast, beta_slow, attention_factor), or None for plain RoPE
    full_rope: Optional[tuple] = ("yarn", 16.0, 8192, 32.0, 1.0, 1.2772588722239782)
    rms_norm_eps: float = 1e-6
    max_position: int = 131072
    dtype: str = "bfloat16"
    flash: str = "auto"  # see LlamaConfig.flash

    def __post_init__(self):
        if len(self.layer_types) != self.num_layers:
            raise ValueError(f"{len(self.layer_types)} layer_types for {self.num_layers} layers")
        unknown = set(self.layer_types) - {"sliding_attention", "full_attention"}
        if unknown:
            raise ValueError(f"unknown layer types {sorted(unknown)}")

    def layer_window(self, li: int) -> Optional[int]:
        """Positions layer ``li`` attends to (itself included), or None for
        a full layer."""
        return self.sliding_window if self.layer_types[li] == "sliding_attention" else None

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]
