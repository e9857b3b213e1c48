"""Step-cost accounting: FLOPs, MFU, collective traffic, byte models.

The JAX package reads these from the compiled XLA program
(``cost_analysis()``, ``memory_analysis()``, the HLO text).  The port
compiles no program, so each number comes from where the port has it:

- **FLOPs**: :func:`count_step_flops` runs the step's objective forward
  and backward under ``torch.utils.flop_counter.FlopCounterMode`` on
  ``meta`` copies of the parameters and the batch (a process's first
  dispatch mode imports ``torch._dynamo``: seconds, once).  Nothing
  runs on the device: no kernel launches, no state, RNG stream or batch
  order changes.  The attention kernels are ctypes calls the counter cannot
  see; on ``meta`` tensors their wrappers return outputs of the right
  shape and add the products each kernel computes
  (``ops/flash_attention.py::meta_flops``), so attention is counted as
  the card runs it.  There is no ``bytes_accessed``: the port has no
  program whose memory traffic an analysis could read.
- **memory**: the caching allocator's peak allocated and reserved bytes
  after the first step (:func:`memory_stats`); absent on the host, as
  JAX's is on the CPU.
- **collectives**: :func:`collective_census` over the tally that
  ``comm/collectives.py`` keeps while the first real step runs: bytes,
  count and bytes by dtype under JAX's kind names (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``) and dtype names (``f32``, ``bf16``, ``s8``,
  ...).  The tally adds no launch.

The CLI's ``--metrics-dir`` run emits them as one ``compiled_cost``
event (:func:`step_cost_report`) after the first step, and
``tools/telemetry_report.py`` divides its FLOPs by the measured step
time for MFU.  The analytic byte and memory models (the DCN and ICI
bytes of a gradient sync, the pipeline's stage-boundary bytes, the KV
pool's bytes, the activation estimates) are arithmetic over the port's
own mesh, ``Placement`` and ``GradSync``; for the same configuration
they give the JAX package's numbers.
"""

from __future__ import annotations

from typing import Any

# Dense bf16 peaks for MFU accounting, keyed by substrings of
# ``torch.cuda.get_device_name()``.  Data-sheet figures (NVIDIA H100
# data sheet, dense Tensor Core bf16), not measurements.
PEAK_FLOPS = (
    (("h100 80gb hbm3", "h100 sxm"), 989e12),
    (("h100 pcie",), 756e12),
)

# JAX's HLO dtype names, the census's keys.
_DTYPE_NAMES = {
    "torch.float64": "f64", "torch.float32": "f32", "torch.bfloat16": "bf16",
    "torch.float16": "f16", "torch.int64": "s64", "torch.int32": "s32",
    "torch.int16": "s16", "torch.int8": "s8", "torch.uint8": "u8",
    "torch.bool": "pred",
}

COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)


def dtype_name(dtype) -> str:
    """JAX's HLO name of a torch dtype (``f32``, ``bf16``, ``s8``, ...)."""
    return _DTYPE_NAMES.get(str(dtype), str(dtype).replace("torch.", ""))


def _meta(t):
    import torch

    return torch.empty_like(t, device="meta").requires_grad_(
        t.requires_grad)


def count_step_flops(loss_fn, params: dict, batch: dict) -> float:
    """FLOPs of one forward and backward of ``loss_fn(params, batch) ->
    loss`` on ``meta`` copies of ``params`` and ``batch`` (module
    docstring): the counter's total plus the attention kernels'
    products."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops import flash_attention as fa

    mparams = {n: _meta(p) for n, p in params.items()}
    mbatch = {k: torch.empty_like(v, device="meta") for k, v in batch.items()}
    fa.meta_flops = 0
    with FlopCounterMode(display=False) as counter:
        loss = loss_fn(mparams, mbatch)
        leaves = [p for p in mparams.values() if p.requires_grad]
        torch.autograd.grad(loss, leaves, allow_unused=True)
    flops = float(counter.get_total_flops() + fa.meta_flops)
    fa.meta_flops = 0
    return flops


def compiled_cost(loss_fn, params: dict, batch: dict) -> dict[str, float]:
    """``{"flops"}`` of one train step (:func:`count_step_flops`); the
    port has no ``bytes_accessed`` (module docstring)."""
    return {"flops": count_step_flops(loss_fn, params, batch)}


def memory_stats(device=None) -> dict[str, int] | None:
    """The caching allocator's peak allocated and reserved bytes on
    ``device`` (the current card by default); None on the host."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return {
        "peak_allocated_bytes": int(torch.cuda.max_memory_allocated(device)),
        "peak_reserved_bytes": int(torch.cuda.max_memory_reserved(device)),
    }


def memory_totals(mem: dict[str, int]) -> int:
    """Peak-footprint scalar from a :func:`memory_stats` dict: the peak
    the tensors held (the allocator's reserve above it is cache)."""
    return int(mem.get("peak_allocated_bytes", 0))


def collective_census(tally: dict) -> dict[str, dict[str, Any]]:
    """Per-kind ``{"bytes", "count", "by_dtype"}`` of a collective tally
    (``comm.collectives.census_tally``): the kinds that ran, each with
    its result bytes (an all-gather's gathered tensor, a reduce-scatter's
    block, as the JAX census reads an HLO op's result shape)."""
    census = {}
    for kind in COLLECTIVE_KINDS:
        entry = tally.get(kind)
        if entry and entry["count"]:
            census[kind] = {"bytes": int(entry["bytes"]),
                            "count": int(entry["count"]),
                            "by_dtype": dict(entry["by_dtype"])}
    return census


def peak_flops_for(device_kind: str | None = None) -> float | None:
    """Peak FLOP/s for MFU accounting, None when unknown (the host, an
    unlisted card)."""
    if not device_kind:
        import torch

        if not torch.cuda.is_available():
            return None
        device_kind = torch.cuda.get_device_name()
    kind = device_kind.lower()
    for patterns, peak in PEAK_FLOPS:
        if any(p in kind for p in patterns):
            return peak
    return None


def mfu(flops_per_step: float, step_time_s: float,
        peak_flops: float | None) -> float | None:
    """Model FLOPs utilization: achieved FLOP/s over the hardware peak."""
    if not peak_flops or step_time_s <= 0:
        return None
    return flops_per_step / step_time_s / peak_flops


def step_cost_report(
    flops: float, *, peak_flops: float | None = None,
    memory: dict | None = None, collectives: dict | None = None,
) -> dict[str, Any]:
    """The ``compiled_cost`` event payload for one train step."""
    report: dict[str, Any] = {"flops": float(flops)}
    if memory:
        report["memory"] = memory
    if collectives is not None:
        report["collectives"] = collectives
    report["peak_flops"] = (
        peak_flops if peak_flops is not None else peak_flops_for()
    )
    return report


# ---------------------------------------------------------------------- #
# analytic byte models
# ---------------------------------------------------------------------- #


def spec_shard_factor(spec: Any, mesh: Any) -> int:
    """Number of distinct shards a ``PartitionSpec`` tiles an array into
    over ``mesh`` — the divisor from global bytes to per-rank bytes."""
    factor = 1
    for entry in spec:
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        for ax in axes:
            factor *= mesh.shape.get(ax, 1)
    return factor


def _leaf_bytes(leaf: Any) -> int:
    n = 1
    for d in tuple(leaf.shape):
        n *= int(d)
    return n * leaf.element_size()


def tree_bytes_per_device(
    tree: dict, *, mesh: Any = None, rules: Any = None,
    shardings: dict | None = None,
) -> int:
    """Per-rank bytes of a dict of whole (global-shape) tensors, ``meta``
    ones included.  Layout intent comes from ``rules`` (a
    ``ShardingRules`` over ``mesh``) or an explicit ``shardings`` dict of
    ``PartitionSpec``s by name; with neither, every leaf counts whole."""
    if rules is not None and mesh is not None:
        from ..parallel.sharding import infer_params_sharding

        shardings = infer_params_sharding(
            {n: tuple(t.shape) for n, t in tree.items()}, mesh, rules)
    if shardings is None:
        return sum(_leaf_bytes(t) for t in tree.values())
    return sum(
        _leaf_bytes(t) // spec_shard_factor(shardings.get(n) or (), mesh)
        for n, t in tree.items()
    )


def kv_heads_shard(num_heads: int, tp: int) -> int:
    """Shard factor on the heads axis: ``tp`` when it divides the head
    count, else 1 (indivisible heads replicate)."""
    return tp if tp > 1 and num_heads % tp == 0 else 1


def kv_position_bytes(
    head_dim: int, *, itemsize: int = 4, dtype: str | None = None,
) -> int:
    """Bytes ONE (position, head) cache entry costs under a KV storage
    dtype (``--serve-kv-dtype``): ``None`` prices native storage at
    ``itemsize``, ``"bf16"`` 2, ``"int8"`` / ``"int4"`` their payload
    plus the bf16 scale per position and head
    (``comm.compress.quantize_kv``)."""
    if dtype is None:
        return head_dim * itemsize
    if dtype == "bf16":
        return head_dim * 2
    if dtype == "int8":
        return head_dim + 2
    if dtype == "int4":
        return head_dim // 2 + 2
    raise ValueError(f"unknown kv dtype {dtype!r} (bf16|int8|int4)")


def kv_pool_model_bytes(
    *, num_layers: int, num_heads: int, head_dim: int, max_len: int,
    num_slots: int = 0, paged: bool = False, num_blocks: int = 0,
    block_size: int = 0, itemsize: int = 4, tp: int = 1,
    index_bytes: int = 0, dtype: str | None = None,
) -> int:
    """Analytic per-rank bytes of a KV-cache pool.  Contiguous: ``L x
    2(K,V) x (num_slots, H, max_len, Dh)``; paged: ``L x 2 x (num_blocks,
    H, block_size, Dh)``; at :func:`kv_position_bytes` an entry, split
    over ``tp`` on the heads when divisible, plus ``index_bytes``."""
    pos = kv_position_bytes(head_dim, itemsize=itemsize, dtype=dtype)
    if paged:
        kv = num_layers * 2 * num_blocks * num_heads * block_size * pos
    else:
        kv = num_layers * 2 * num_slots * num_heads * max_len * pos
    return kv // kv_heads_shard(num_heads, tp) + index_bytes


def kv_block_model_bytes(
    *, num_layers: int, num_heads: int, head_dim: int, block_size: int,
    itemsize: int = 4, dtype: str | None = None,
) -> int:
    """Bytes of ONE physical KV block across every layer's K and V: the
    unit a host-tier spill or restore moves (``serve/kv_store.py``)."""
    return num_layers * 2 * num_heads * block_size * kv_position_bytes(
        head_dim, itemsize=itemsize, dtype=dtype
    )


def serve_activation_estimate(
    *, num_slots: int, width: int, hidden: int, num_heads: int,
    vocab: int, mask_len: int, paged: bool = False,
    cache_bytes: int = 0, itemsize: int = 4, head_dim: int = 0,
    kv_quant: bool = False,
) -> int:
    """Coarse working-set estimate for one serving forward of ``width``
    positions a slot (the JAX package's formula): the qkv and MLP
    intermediates, the scores over the cache window and the logits row,
    per layer; paged layouts add a quarter of the cache for the gathers,
    a quantized pool its dequantized f32 K and V windows."""
    per_pos = 3 * hidden + 4 * hidden + vocab + num_heads * mask_len
    est = num_slots * width * per_pos * itemsize
    if paged:
        est += cache_bytes // 4
    if kv_quant:
        est += 2 * num_slots * num_heads * mask_len * head_dim * 4
    return est


def train_activation_estimate(
    *, param_bytes_per_device: int, batch_rows_per_device: int,
    seq_len: int, vocab: int, itemsize: int = 4,
) -> int:
    """Coarse forward-and-backward working-set estimate for one train
    step (the JAX package's formula): the gradients plus the logits,
    each counted twice (value and cotangent)."""
    logits = batch_rows_per_device * seq_len * vocab * itemsize
    return 2 * (param_bytes_per_device + logits)


def dcn_step_counters(
    *,
    grad_sync: Any | None = None,
    mesh: Any | None = None,
    params: Any | None = None,
    mode: str = "flat",
    n_slices: int | None = None,
    num_microbatches: int = 1,
) -> dict[str, float]:
    """Per-step counters for the analytic DCN byte model, one sync
    spelled the way the configured ``--grad-sync`` mode moves it.

    With a ``GradSync`` the counters come off the engine (its padded
    bucket layout and overlap contract).  The flat all-reduce has no
    engine: the model is evaluated on the parameter count over the data
    axis split into the detected (or given) slices, so a flat run's
    counters stay comparable to a hier run's.  ``params``: a dict of
    whole tensors, or of their shapes."""
    if grad_sync is not None:
        per_sync = grad_sync.dcn_bytes_per_sync()
        syncs = grad_sync.syncs_per_step(num_microbatches)
        return {
            "dcn_bytes": float(per_sync * syncs),
            "ici_bytes": float(grad_sync.ici_bytes_per_sync() * syncs),
            "dcn_syncs": float(syncs),
        }
    if mesh is None or params is None:
        raise ValueError("flat-mode counters need mesh and params")
    from ..comm.hierarchical import dcn_bytes_per_sync
    from ..comm.mesh import AXIS_DATA, num_slices

    size = mesh.axes_size((AXIS_DATA,))
    slices = num_slices() if n_slices is None else int(n_slices)
    if slices < 1 or size % slices:
        raise ValueError(
            f"axis {AXIS_DATA!r} (size {size}) not divisible into "
            f"{slices} slices")
    n_elems = 0
    for x in params.values():
        shape = x if isinstance(x, (tuple, list)) else tuple(x.shape)
        n = 1
        for d in shape:
            n *= int(d)
        n_elems += n
    # One sync per optimizer step (the flat path has no per-microbatch
    # overlap); no ici_bytes entry: the all-reduce's staging within a
    # node is the backend's choice, not a modeled transfer.
    return {
        "dcn_bytes": float(dcn_bytes_per_sync(n_elems, slices,
                                              size // slices, mode)),
        "dcn_syncs": 1.0,
    }


# Within-node fabric constants for the sync wall model, the counterparts
# of the cross-node link's ``comm.compress.LINK_LATENCY_S`` /
# ``LINK_BYTES_PER_S``: NVLink 4 on
# an H100 SXM moves 900 GB/s a card over its 18 links, both directions
# together (NVIDIA H100 data sheet), so 450 GB/s each way a rank; the
# 2 us a collective launch is an assumption.  Neither is measured: NCCL
# has not run across cards in this repo.
ICI_LATENCY_S = 2e-6
ICI_BYTES_PER_S = 450e9


def grad_sync_wall_model(
    *,
    ici_bytes: float,
    dcn_bytes: float,
    n_buckets: int,
    n_slices: int,
    ici_size: int,
    stripe: int = 1,
    phase_overlap: bool = False,
) -> dict[str, float]:
    """Overlap-aware analytic wall for ONE sync, per fabric (the JAX
    package's model over the port's link constants).

    Per bucket, the within-node phases (reduce-scatter and all-gather)
    cost one launch each plus the bucket's share of the ICI bytes over
    the ``S x L`` links; the cross-node hop one launch plus the bucket's
    per-rail payload over ``stripe`` edges.  Serialized phases cost
    ``nb·(u+v)``; the phase-pipelined wavefront (``--grad-sync-overlap``)
    ``nb·max(u,v) + min(u,v)``.  ``wall_s`` is the configured schedule's
    wall; both are reported."""
    from ..comm.compress import LINK_BYTES_PER_S, LINK_LATENCY_S

    nb = max(int(n_buckets), 1)
    k = max(int(stripe), 1)
    links = max(n_slices * ici_size, 1)
    u = 2 * ICI_LATENCY_S + (ici_bytes / nb) / (links * ICI_BYTES_PER_S)
    rail_bytes = (dcn_bytes / nb) / max(ici_size, 1)
    v = LINK_LATENCY_S + rail_bytes / (k * LINK_BYTES_PER_S)
    wall_serial = nb * (u + v)
    wall_overlap = nb * max(u, v) + min(u, v)
    return {
        "ici_per_bucket_s": u,
        "dcn_per_bucket_s": v,
        "wall_serial_s": wall_serial,
        "wall_overlap_s": wall_overlap,
        "bubble_s": min(u, v),
        "wall_s": wall_overlap if phase_overlap else wall_serial,
        "overlap_ratio": wall_serial / wall_overlap,
    }


def pp_step_counters(
    *,
    schedule: str,
    num_stages: int,
    num_microbatches: int,
    microbatch_rows: int,
    seq_len: int,
    hidden: int,
    act_itemsize: int = 4,
    mode: str = "none",
    num_chunks: int = 1,
    n_slices: int | None = None,
) -> dict[str, float]:
    """Per-step counters for the pipeline stage-boundary byte model
    (``comm.compress.pp_boundary_bytes_per_step``): ``pp_boundary_bytes``
    every hop's payload bytes a step (both directions, the wrap edge
    included), ``pp_dcn_bytes`` the share on edges that cross a node
    (``n_slices`` of the ring's ``num_stages`` edges with the stages
    laid out contiguously; 0 on one node, detected when not given)."""
    from ..comm.compress import pp_boundary_bytes_per_step
    from ..comm.mesh import num_slices as _num_slices

    total = pp_boundary_bytes_per_step(
        schedule=schedule, num_stages=num_stages,
        num_microbatches=num_microbatches, microbatch_rows=microbatch_rows,
        seq_len=seq_len, hidden=hidden, act_itemsize=act_itemsize,
        mode=mode, num_chunks=num_chunks,
    )
    if n_slices is None:
        n_slices = _num_slices()
    crossing = min(n_slices, num_stages) if n_slices > 1 else 0
    return {
        "pp_boundary_bytes": float(total),
        "pp_dcn_bytes": float(total * crossing // num_stages),
    }
