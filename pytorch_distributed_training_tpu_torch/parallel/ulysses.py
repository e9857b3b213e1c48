"""Ulysses sequence parallelism: the counterpart of the JAX package's
``parallel/ulysses.py`` (DeepSpeed-Ulysses, Jacobs et al. 2023).

Attention is parallel over heads, so this rank's (B, L/n, H, D)
sequence shard is all-to-all'd into a (B, L, H/n, D) head shard, the
dispatching ``ops.attention.dot_product_attention`` runs on it with the
whole sequence visible — the CUDA flash kernels on the card at their
lengths — and a second all-to-all brings the output back to sequence
shards.  Both all-to-alls are differentiable
(``comm.collectives.all_to_all_grad``: the backward is the inverse
all-to-all).  The operands are made contiguous before the attention, as
the flash kernel's 16-byte row rule asks.
"""

from __future__ import annotations

from ..comm.collectives import all_to_all_grad
from ..ops.attention import dot_product_attention


def ulysses_attention(q, k, v, parallel, *, causal: bool = False,
                      attn_fn=dot_product_attention):
    """Sequence-parallel attention on this rank's (B, L/n, H, D) shards
    over ``parallel``'s sequence group (``parallel/sharded.py``); ``H``
    (this rank's heads, its tensor shard under tensor parallelism) must
    divide by the group's size."""
    n, group = parallel.sp_size, parallel.sp_group
    h = q.shape[2]
    if h % n:
        raise ValueError(
            f"Ulysses needs heads ({h}) divisible by tensor x 'sequence' "
            f"({n}) (each member owns whole heads after the all-to-all); "
            "use ring_attention otherwise")

    def seq_to_heads(x):
        return all_to_all_grad(x, group, split_axis=2,
                               concat_axis=1).contiguous()

    out = attn_fn(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                  causal=causal)
    return all_to_all_grad(out.contiguous(), group, split_axis=1,
                           concat_axis=2)
