"""Multi-device scaling over `torch.distributed` (PyTorch port of
`icp4dradar_tpu/parallel/`): a mesh over the ranks of a process group,
data-parallel scan batches, and the factor-sharded distributed pose-graph
Gauss-Newton with all-reduced normal equations. One rank drives one
device: NCCL on the card, gloo on the CPU.

Not ported yet (`ROADMAP.md` queue 1 items 6b and 6c): the sharded map,
the ring VGICP, the distributed pipeline and the multi-host helpers."""

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
