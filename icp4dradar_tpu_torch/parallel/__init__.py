"""Multi-device scaling over `torch.distributed` (PyTorch port of
`icp4dradar_tpu/parallel/`): a mesh over the ranks of a process group,
data-parallel scan batches, the factor-sharded distributed pose-graph
Gauss-Newton with all-reduced normal equations, the voxel map sharded by
slot range, the ring VGICP against a sharded submap, the distributed
scan-to-map pipeline with its checkpoints, and the multi-process runtime.
One rank drives one device: NCCL on the card, gloo on the CPU."""

from icp4dradar_tpu_torch.parallel.mesh import make_mesh, device_count  # noqa: F401
from icp4dradar_tpu_torch.parallel.distributed_gn import (  # noqa: F401
    distributed_block_normal_equations,
    distributed_normal_equations,
    distributed_optimize_pose_graph,
    distributed_optimize_pose_graph_block,
    pad_factors_for_mesh,
)
from icp4dradar_tpu_torch.parallel.batch import (  # noqa: F401
    shard_scan_batch,
    batched_preprocess,
    batched_icp_pairs,
    sharded_scan_to_map_batch,
)
from icp4dradar_tpu_torch.parallel.sharded_map import (  # noqa: F401
    ShardedVoxelMap,
    sharded_map_create,
    sharded_map_insert,
    sharded_map_rehash,
    sharded_sector_search_with_stats,
)
from icp4dradar_tpu_torch.parallel.ring_vgicp import (  # noqa: F401
    ring_vgicp_align,
    ring_vgicp_normal_equations,
)
from icp4dradar_tpu_torch.parallel.distributed_pipeline import (  # noqa: F401
    load_distributed_state,
    run_scan_to_map_distributed,
    save_distributed_state,
)
from icp4dradar_tpu_torch.parallel.multihost import (  # noqa: F401
    assemble_global_scans,
    global_mesh,
    maybe_initialize_distributed,
    process_frame_slice,
    run_scan_to_map_multihost,
)
