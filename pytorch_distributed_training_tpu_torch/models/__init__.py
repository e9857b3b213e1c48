"""Models of the port: GPT-2 (dense), the ResNets, the ViTs, their JAX
weight bridge, generation."""

from .convert import (
    gpt2_params_from_jax, gpt2_params_to_jax, resnet_params_from_jax,
    resnet_params_to_jax, train_state_from_jax, train_state_to_jax,
    vit_params_from_jax, vit_params_to_jax,
)
# `generate` is the JAX package's public name for the function; the module
# is reached by a from-import of its path (`from ..models.generate import`).
# graftcheck: disable=init-shadows-submodule — the JAX package's public name
from .generate import eos_cut_length, filter_logits, generate, sample_logits
from .gpt2 import (
    GPT2, Block, GPT2Config, gpt2_124m, gpt2_large, gpt2_medium, gpt2_xl,
)
from .layers import (
    MAX_FUSED_DECODE_CHUNK, SelfAttention, new_kv_blocks, new_kv_cache,
)
from .registry import MODEL_NAMES, create_model, model_kind
from .resnet import (
    BasicBlock, Bottleneck, ResNet, resnet18, resnet34, resnet50, resnet101,
    resnet152,
)
from .vit import (
    EncoderBlock, MlpBlock, ViTConfig, VisionTransformer, vit_b16, vit_l16,
    vit_s16,
)

__all__ = [
    "GPT2", "Block", "GPT2Config", "SelfAttention", "MAX_FUSED_DECODE_CHUNK",
    "new_kv_cache", "new_kv_blocks", "gpt2_124m", "gpt2_medium",
    "gpt2_large", "gpt2_xl",
    "gpt2_params_from_jax", "gpt2_params_to_jax", "generate",
    "sample_logits", "filter_logits",
    "eos_cut_length", "create_model", "model_kind", "MODEL_NAMES",
    "ResNet", "BasicBlock", "Bottleneck", "resnet18", "resnet34",
    "resnet50", "resnet101", "resnet152", "resnet_params_from_jax",
    "resnet_params_to_jax", "VisionTransformer", "ViTConfig", "EncoderBlock",
    "MlpBlock", "vit_s16", "vit_b16", "vit_l16", "vit_params_from_jax",
    "vit_params_to_jax", "train_state_from_jax", "train_state_to_jax",
]
