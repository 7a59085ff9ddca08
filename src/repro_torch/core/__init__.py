"""Core: the paper's contribution — SCV/SCV-Z sparse aggregation.

The reference's re-exports (``src/repro/core/__init__.py``), under the
same names."""
from repro_torch.core.aggregate import (
    aggregate,
    aggregate_bcsr,
    aggregate_coo_scatter,
    aggregate_coo_segsum,
    aggregate_dense,
    aggregate_scv_plan,
    aggregate_scv_tiles,
)
from repro_torch.core.formats import (
    BCSRMatrix,
    COOMatrix,
    CSBMatrix,
    CSCMatrix,
    CSRMatrix,
    block_diag_coo,
    coo_from_dense,
    coo_to_bcsr,
    coo_to_csb,
    coo_to_csc,
    coo_to_csr,
    csc_to_coo,
    csr_to_coo,
)
from repro_torch.core.exec import (
    PlanExecutor,
    ShardedPlan,
    ShardingDecision,
    aggregate_sharded,
    decide_sharding,
    placement_bytes,
)
from repro_torch.core.morton import morton_decode, morton_encode, morton_order, zcurve_tiles
from repro_torch.core.partition import (
    Partition,
    load_imbalance,
    shard_plan,
    shard_tiles,
    split_equal_nnz,
)
from repro_torch.core.scv import (
    MXU_VPU_RATIO,
    ROW_MAJOR,
    ZMORTON,
    SCVBucketedPlan,
    SCVMatrix,
    SCVPlan,
    SCVTiles,
    bucket_caps_for,
    bucket_tiles,
    coo_to_scv,
    coo_to_scv_tiles,
    dense_tile_threshold,
    plan_from_tiles,
    plan_from_tiles_bucketed,
    scv_to_tiles,
    tile_nnz_histogram,
)

__all__ = [k for k in dir() if not k.startswith("_")]
