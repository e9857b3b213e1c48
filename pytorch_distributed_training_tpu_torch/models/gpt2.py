"""GPT-2: the counterpart of the JAX package's ``models/gpt2.py``.

Decoder-only transformer (Radford et al. 2019): learned position
embeddings, pre-LN blocks, tanh-approximated GELU MLP, LM head tied to the
token embedding.  The parameter layout follows flax's so that
``models/convert.py`` maps a JAX param tree onto this module one to one;
LayerNorm uses flax's epsilon, 1e-6.

Training: dropout draws its masks from an explicit generator that the
train step hands down (never from the global RNG), and ``remat`` runs
each block under ``torch.utils.checkpoint``.

The MoE variant (``num_experts > 0``, ``models/moe.py``): every odd block
(``i % 2 == 1``) is a ``MoeBlock``.  ``forward(..., return_moe=True)``
returns ``(out, moe)``, ``moe`` holding the sum of the MoE layers' aux
losses and the mean of their drop rates (``moe_aux_loss``,
``moe_drop_rate``; JAX sows them).  As in JAX, MoE is a training path:
decoding with a KV cache and sequence parallelism refuse it.

Tensor and sequence parallelism (a ``parallel`` context set by
``parallel/sharded.py::configure_model``): a block whose ``mlp_up`` /
``mlp_down`` hold their tensor shards runs Megatron's MLP (``f``, the
column-parallel up projection and GELU on the rank's hidden units, the
row-parallel down projection without its bias, ``g``, the bias); the
attention is ``models/layers.py``'s.  Under a sequence group the model
takes this rank's L/n positions of each row and embeds them at their
global positions (``wpe`` rows ``i*L/n ..``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..comm.collectives import copy_to_group, reduce_from_group
from ..utils.device import resolve_device
from .layers import SelfAttention, new_kv_blocks, new_kv_cache

LN_EPS = 1e-6  # flax.linen.LayerNorm's default


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    hidden_dim: int = 768
    mlp_ratio: int = 4
    dropout_rate: float = 0.0
    tie_embeddings: bool = True
    num_experts: int = 0
    moe_capacity_factor: float = 1.25
    # Token -> expert-buffer formulation (models/moe.py): einsum | scatter.
    moe_dispatch: str = "einsum"
    # Rematerialize each block in the backward (JAX ``nn.remat``): only the
    # block inputs are saved; the forward reruns inside the backward.
    remat: bool = False


def dropout(x, rate: float, generator: torch.Generator | None):
    """flax ``nn.Dropout``: keep each element with probability 1 - rate
    and scale it by 1 / (1 - rate), masks drawn from ``generator``.  With
    no generator (evaluation) or rate 0 it returns ``x``."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal`` in place: a normal truncated at 2 sigma and
    rescaled to variance 1 / fan_in (0.87962566 is that truncation's
    stddev); fan_in is every dim but the first (a Linear's input width, a
    convolution's in x kh x kw)."""
    std = math.sqrt(1.0 / weight[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


def _site_generator(seed, device):
    """The generator one dropout site draws from, or None (no dropout)."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


class Block(nn.Module):
    parallel = None   # parallel/sharded.py::configure_model

    def __init__(self, cfg: GPT2Config, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_dim
        self.ln1 = nn.LayerNorm(d, eps=LN_EPS, **kw)
        self.attn = SelfAttention(d, cfg.num_heads, causal=True, **kw)
        self.ln2 = nn.LayerNorm(d, eps=LN_EPS, **kw)
        self.mlp_up = nn.Linear(d, d * cfg.mlp_ratio, **kw)
        self.mlp_down = nn.Linear(d * cfg.mlp_ratio, d, **kw)
        self.mlp_ratio = cfg.mlp_ratio
        self.dropout_rate = cfg.dropout_rate

    def forward(self, x, *, cache=None, positions=None, attn_mask=None,
                block_table=None, dropout_seed=None):
        """``dropout_seed`` (training with dropout): the block's two masks
        come from one generator seeded with it, so a rematerialized
        forward draws the same masks again."""
        gen = _site_generator(dropout_seed, x.device)
        y = self.attn(
            self.ln1(x), cache=cache, positions=positions,
            attn_mask=attn_mask, block_table=block_table,
        )
        x = x + dropout(y, self.dropout_rate, gen)
        y = self.ln2(x)
        if self.mlp_up.weight.shape[0] < self.mlp_down.weight.shape[0] * \
                self.mlp_ratio:
            # Tensor shards of the MLP (module docstring).
            group = self.parallel.tp_group
            y = F.gelu(self.mlp_up(copy_to_group(y, group)),
                       approximate="tanh")
            y = reduce_from_group(F.linear(y, self.mlp_down.weight),
                                  group) + self.mlp_down.bias
        else:
            y = self.mlp_down(F.gelu(self.mlp_up(y), approximate="tanh"))
        return x + dropout(y, self.dropout_rate, gen)


def _block_call(block, params, x, dropout_seed):
    """One block as a function of its parameters: under remat the
    backward's recompute then runs on the tensors the forward ran on (the
    step's compute-dtype copies), not on the module's own parameters.
    An MoE block returns ``(x, aux, drop_rate)``."""
    return torch.func.functional_call(
        block, params, (x,), {"dropout_seed": dropout_seed}
    )


class GPT2(nn.Module):
    """Decoder-only LM: (B, L) int tokens → (B, L, vocab) f32 logits.

    Without a cache the forward is the full causal sequence.  With
    ``cache`` (a list of per-layer (k, v) pairs from ``new_cache``) and
    ``positions`` (B,) int32, row b's tokens sit at positions
    ``positions[b]..`` and their K/V are written into its cache row (slot
    mode, see ``models/layers.py``).  With ``block_table`` (B, nb) int32
    as well, ``cache`` is the paged pool from ``new_block_cache`` and row
    b's positions route through its table row.  Rows at or past
    ``max_seq_len`` are idle: their position-embedding gather is clipped
    and their output is garbage the caller discards.
    """

    parallel = None   # parallel/sharded.py::configure_model

    def __init__(self, cfg: GPT2Config, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_dim, **kw))
        self.wpe = nn.Parameter(torch.empty(cfg.max_seq_len, cfg.hidden_dim, **kw))
        self.blocks = nn.ModuleList(
            _moe_block(cfg, **kw) if is_moe_layer(cfg, i) else Block(cfg, **kw)
            for i in range(cfg.num_layers)
        )
        self.ln_final = nn.LayerNorm(cfg.hidden_dim, eps=LN_EPS, **kw)
        self.lm_head = (
            None if cfg.tie_embeddings
            else nn.Linear(cfg.hidden_dim, cfg.vocab_size, bias=False, **kw)
        )

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Fresh weights drawn from ``generator``, with the JAX package's
        init rules: wte ~ N(0, 0.02), wpe ~ N(0, 0.01), dense kernels
        lecun-normal (truncated at 2 sigma), biases zero, LayerNorm 1/0.
        The draws differ from ``jax.random``'s; parity tests convert the
        JAX weights instead (``models/convert.py``)."""
        self.wte.normal_(0.0, 0.02, generator=generator)
        self.wpe.normal_(0.0, 0.01, generator=generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif hasattr(m, "init_experts"):
                m.init_experts(generator)

    def _refuse_moe_decode(self):
        if self.cfg.num_experts > 0:
            raise ValueError(
                "decode mode supports the dense single-device attention "
                "path (no MoE, no sp_mesh)")

    def local_heads(self) -> int:
        """The attention heads this rank holds: all of them, or under a
        tensor shard of ``qkv`` (tensor-parallel serving) its share."""
        head_dim = self.cfg.hidden_dim // self.cfg.num_heads
        return self.blocks[0].attn.qkv.weight.shape[0] // (3 * head_dim)

    def new_cache(self, batch: int, length: int):
        """Zeroed per-layer KV caches for ``batch`` rows of ``length``
        positions at this rank's heads (``local_heads``), in this model's
        dtype and on its device."""
        if not 1 <= length <= self.cfg.max_seq_len:
            raise ValueError(
                f"cache length {length} outside 1..{self.cfg.max_seq_len} "
                "(the model's position table bounds the cache)"
            )
        self._refuse_moe_decode()
        cfg = self.cfg
        return [
            new_kv_cache(
                batch, self.local_heads(), length,
                cfg.hidden_dim // cfg.num_heads,
                dtype=self.wte.dtype, device=self.wte.device,
            )
            for _ in range(cfg.num_layers)
        ]

    def new_block_cache(self, num_blocks: int, block_size: int,
                        kv_quant: str | None = None):
        """Zeroed per-layer paged pools of ``num_blocks`` blocks of
        ``block_size`` positions (plus each layer's scratch block) at this
        rank's heads, in this model's dtype and on its device;
        ``kv_quant`` "int8"/"int4" stores the quantized payload and bf16
        scales instead."""
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"num_blocks ({num_blocks}) and block_size ({block_size}) "
                "must be >= 1"
            )
        self._refuse_moe_decode()
        cfg = self.cfg
        return [
            new_kv_blocks(
                num_blocks, self.local_heads(), block_size,
                cfg.hidden_dim // cfg.num_heads, dtype=self.wte.dtype,
                device=self.wte.device, kv_quant=kv_quant,
            )
            for _ in range(cfg.num_layers)
        ]

    def forward(self, tokens, *, cache=None, positions=None, attn_mask=None,
                block_table=None, return_hidden: bool = False,
                generator: torch.Generator | None = None,
                return_moe: bool = False):
        """``return_hidden=True`` skips the LM head and returns the final
        hidden states (B, L, D) in the model dtype (``head`` applies it).
        ``return_moe=True`` returns ``(out, moe)`` (module docstring).

        In training mode with ``dropout_rate > 0``, ``generator`` (a CPU
        ``torch.Generator``) is required: every dropout site draws its own
        seed from it on the host, so no draw waits for the device.  With
        ``cfg.remat``, training runs each block under
        ``torch.utils.checkpoint`` (non-reentrant)."""
        cfg = self.cfg
        b, l = tokens.shape
        if cfg.num_experts > 0:
            if cache is not None:
                self._refuse_moe_decode()
            if self.parallel is not None and self.parallel.sp_size > 1:
                raise ValueError(
                    "sequence-parallel attention supports dense GPT-2 only "
                    "(MoE blocks are not SP-wired)")
        drop = self.training and cfg.dropout_rate > 0.0 and cache is None
        if drop and generator is None:
            raise ValueError(
                "dropout_rate > 0 in training needs an explicit generator "
                "(the train step hands one down)"
            )
        seeds = (
            torch.randint(2**62, (cfg.num_layers + 1,), generator=generator)
            .tolist() if drop else [None] * (cfg.num_layers + 1)
        )
        remat = (cfg.remat and self.training and cache is None
                 and torch.is_grad_enabled())
        if cache is None:
            if positions is not None or block_table is not None:
                raise ValueError("positions and block_table need a KV cache")
            off = 0
            if self.parallel is not None and self.parallel.sp_size > 1:
                off = self.parallel.sp_index * l
            pos = self.wpe[off:off + l][None]
        else:
            if positions is None:
                raise ValueError("a KV cache needs positions")
            cols = positions[:, None].long() + torch.arange(l, device=tokens.device)
            pos = self.wpe[cols.clamp(0, cfg.max_seq_len - 1)]
        x = dropout(self.wte[tokens] + pos, cfg.dropout_rate,
                    _site_generator(seeds[0], tokens.device))
        auxes, drops = [], []
        for i, block in enumerate(self.blocks):
            if remat:
                x = checkpoint(_block_call, block,
                               dict(block.named_parameters()), x,
                               seeds[i + 1], use_reentrant=False)
            elif is_moe_layer(cfg, i):
                x = block(x, dropout_seed=seeds[i + 1])
            else:
                x = block(
                    x, cache=None if cache is None else cache[i],
                    positions=positions, attn_mask=attn_mask,
                    block_table=block_table, dropout_seed=seeds[i + 1],
                )
            if is_moe_layer(cfg, i):
                x, aux, drop_rate = x
                auxes.append(aux)
                drops.append(drop_rate)
        x = self.ln_final(x)
        out = x if return_hidden else self.head(x)
        if not return_moe:
            return out
        return out, moe_summary(auxes, drops, x.device)

    def head(self, x):
        """LM head over final hidden states: logits computed in the model
        dtype, returned as f32."""
        if self.lm_head is None:
            logits = x @ self.wte.t()
        else:
            logits = self.lm_head(x)
        return logits.float()


def is_moe_layer(cfg: GPT2Config, i: int) -> bool:
    """Whether block ``i`` is an MoE block: every odd one, with experts."""
    return cfg.num_experts > 0 and i % 2 == 1


def _moe_block(cfg: GPT2Config, **kw):
    from .moe import MoeBlock

    return MoeBlock(cfg, **kw)


def moe_summary(auxes: list, drops: list, device) -> dict:
    """The step's MoE values (JAX ``train/step.py``'s ``_forward``): the
    sum of the layers' aux losses and the mean of their drop rates (both
    0 without MoE layers)."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"moe_aux_loss": sum(auxes, zero),
            "moe_drop_rate": (sum(drops, zero) / len(drops)) if drops
            else zero}


def _make(defaults: dict, cfg_overrides, device, dtype, seed) -> GPT2:
    cfg = GPT2Config(**{**defaults, **(cfg_overrides or {})})
    model = GPT2(cfg, device=resolve_device(device))
    if model.wte.device.type != "meta":
        gen = torch.Generator(device=model.wte.device).manual_seed(seed)
        model.init_weights(gen)
    return model.to(dtype) if dtype is not None else model


def gpt2_124m(cfg_overrides: dict | None = None, *, device=None, dtype=None,
              seed: int = 0) -> GPT2:
    """GPT-2 small: 12 layers, 768 hidden, 12 heads, 50257 vocab (124M
    params).  Weights are drawn in f32 from ``seed`` and then cast to
    ``dtype``.  ``device`` defaults to CUDA (``utils.device``);
    ``device="meta"`` builds shapes only."""
    return _make({}, cfg_overrides, device, dtype, seed)


def gpt2_medium(cfg_overrides: dict | None = None, *, device=None, dtype=None,
                seed: int = 0) -> GPT2:
    """GPT-2 medium: 24 layers, 1024 hidden, 16 heads (355M params)."""
    return _make({"num_layers": 24, "hidden_dim": 1024, "num_heads": 16},
                 cfg_overrides, device, dtype, seed)


def gpt2_large(cfg_overrides: dict | None = None, *, device=None, dtype=None,
               seed: int = 0) -> GPT2:
    """GPT-2 large: 36 layers, 1280 hidden, 20 heads (774M params)."""
    return _make({"num_layers": 36, "hidden_dim": 1280, "num_heads": 20},
                 cfg_overrides, device, dtype, seed)


def gpt2_xl(cfg_overrides: dict | None = None, *, device=None, dtype=None,
            seed: int = 0) -> GPT2:
    """GPT-2 XL: 48 layers, 1600 hidden, 25 heads (1.56B params)."""
    return _make({"num_layers": 48, "hidden_dim": 1600, "num_heads": 25},
                 cfg_overrides, device, dtype, seed)
