"""Communication of the port: process-group setup (``comm.init``), the
collectives (``comm.collectives``), the slice split of a group
(``comm.mesh``), the codecs (``comm.compress``: the gradient-sync codecs
and the KV-cache codec of the quantized paged pool), striping and the
phase pipeline (``comm.striping``) and the two-tier gradient sync
(``comm.hierarchical``), and the pipeline stage-boundary codec
(``comm.compress.boundary_permute``).  The names the JAX package's
``comm`` exports, where the port has them."""

from .init import initialize, is_initialized, process_count, process_index, shutdown
from .mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_PIPELINE,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
    BATCH_AXES,
    MESH_AXES,
    Mesh,
    MeshConfig,
    batch_shard_size,
    make_hybrid_mesh,
    make_mesh,
    dcn_axis_name,
    ici_axis_name,
    num_slices,
    split_slice_groups,
    stripe_lane_perm,
)
from .compress import (
    PP_COMPRESS_MODES,
    auto_bucket_mb,
    boundary_permute,
    bucket_wire_bytes,
    pp_boundary_bytes_per_step,
)
from .hierarchical import GRAD_SYNC_MODES, GradSync, GradSyncConfig
from .striping import (
    STRIPE_CHOICES,
    ici_bytes_per_sync,
    pipelined_sync,
    resolve_channel_stripe,
    resolve_stripe,
    split_stripes,
    striped_dcn_hop,
)
from .collectives import (
    all_gather,
    all_to_all,
    barrier,
    broadcast,
    pmean,
    ppermute,
    psum,
    reduce_scatter,
)

__all__ = [
    "initialize",
    "is_initialized",
    "process_count",
    "process_index",
    "shutdown",
    "num_slices",
    "split_slice_groups",
    "dcn_axis_name",
    "ici_axis_name",
    "stripe_lane_perm",
    "STRIPE_CHOICES",
    "resolve_stripe",
    "resolve_channel_stripe",
    "split_stripes",
    "striped_dcn_hop",
    "pipelined_sync",
    "ici_bytes_per_sync",
    "GradSync",
    "GradSyncConfig",
    "GRAD_SYNC_MODES",
    "auto_bucket_mb",
    "bucket_wire_bytes",
    "PP_COMPRESS_MODES",
    "boundary_permute",
    "pp_boundary_bytes_per_step",
    "AXIS_DATA",
    "AXIS_FSDP",
    "AXIS_EXPERT",
    "AXIS_PIPELINE",
    "AXIS_SEQUENCE",
    "AXIS_TENSOR",
    "MESH_AXES",
    "BATCH_AXES",
    "Mesh",
    "MeshConfig",
    "make_mesh",
    "make_hybrid_mesh",
    "batch_shard_size",
    "psum",
    "pmean",
    "all_gather",
    "reduce_scatter",
    "ppermute",
    "all_to_all",
    "broadcast",
    "barrier",
]
