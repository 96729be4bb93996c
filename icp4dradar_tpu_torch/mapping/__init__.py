"""Device-resident voxel-hash map (replaces ikd-Tree): insert with
keep-nearest-center downsampling and per-voxel Gaussians, sector query,
forgetting and rehash (single tables, or one table per stream), stencil and
exact whole-map k-NN, and ikd-Tree's radius/box searches, box and point
deletes and box re-add."""

from icp4dradar_tpu_torch.mapping.voxel_hash import (  # noqa: F401
    VoxelHashMap,
    voxel_map_add_box,
    voxel_map_box_search,
    voxel_map_create,
    voxel_map_delete_box,
    voxel_map_delete_box_acquire,
    voxel_map_delete_points,
    voxel_map_forget_far,
    voxel_map_insert,
    voxel_map_knn,
    voxel_map_knn_exact,
    voxel_map_lookup_slots,
    voxel_map_maybe_rehash,
    voxel_map_radius_search,
    voxel_map_rehash,
    voxel_map_sector_search,
    voxel_map_sector_search_with_stats,
    voxel_map_stencil_neighbors,
)
