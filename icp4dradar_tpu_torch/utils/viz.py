"""Visualization exports (PyTorch port of `icp4dradar_tpu/utils/viz.py`;
numpy, writing the JAX package's text for the same inputs) — the
reference's rviz profile (rviz/radar.rviz:
7 displays: map cloud with infinite decay, submap, path, odometries) mapped
to portable artifacts: PLY point clouds (any viewer) and a standalone HTML
trajectory/map viewer (three.js-free SVG/canvas, zero dependencies).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def write_ply(path: str, points: np.ndarray,
              intensity: Optional[np.ndarray] = None) -> None:
    """(N,3) [+ (N,) intensity -> grayscale color] ASCII PLY."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pts = np.asarray(points, dtype=np.float32)
    n = len(pts)
    with_color = intensity is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if with_color:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if with_color:
            inten = np.asarray(intensity, dtype=np.float32)
            lo, hi = float(inten.min()), float(inten.max())
            c = ((inten - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
            for p, ci in zip(pts, c):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {ci} {ci} {ci}\n")
        else:
            for p in pts:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def export_map_ply(path: str, vmap) -> int:
    """Dump a VoxelHashMap's occupied voxel points to PLY (a batched map:
    every stream's); returns the count."""
    occ = vmap.occupied.cpu().numpy() > 0.5
    write_ply(path, vmap.points.cpu().numpy()[occ], vmap.intensity.cpu().numpy()[occ])
    return int(occ.sum())


def write_html_viewer(
    path: str,
    est_positions: np.ndarray,
    gt_positions: Optional[np.ndarray] = None,
    map_points: Optional[np.ndarray] = None,
    title: str = "radar odometry",
) -> None:
    """Self-contained HTML top-down (x,y) view: estimated path, optional GT
    path, optional map cloud. Opens in any browser."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    est = np.asarray(est_positions, dtype=np.float64)[:, :2].tolist()
    gt = (np.asarray(gt_positions, dtype=np.float64)[:, :2].tolist()
          if gt_positions is not None else None)
    mp = None
    if map_points is not None:
        pts = np.asarray(map_points, dtype=np.float64)
        if len(pts) > 20000:
            sel = np.random.default_rng(0).choice(len(pts), 20000, replace=False)
            pts = pts[sel]
        mp = pts[:, :2].tolist()
    import json as _json

    html = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>body{{margin:0;background:#111;color:#ddd;font:13px sans-serif}}
#info{{position:fixed;top:8px;left:8px}}</style></head>
<body><div id="info">{title} — est <span style="color:#4af">blue</span>{
    ', gt <span style="color:#fa4">orange</span>' if gt else ''}</div>
<canvas id="c"></canvas><script>
const est={_json.dumps(est)};
const gt={_json.dumps(gt)};
const mp={_json.dumps(mp)};
const cv=document.getElementById('c');
cv.width=innerWidth;cv.height=innerHeight;
const ctx=cv.getContext('2d');
let xs=est.map(p=>p[0]),ys=est.map(p=>p[1]);
if(gt){{xs=xs.concat(gt.map(p=>p[0]));ys=ys.concat(gt.map(p=>p[1]));}}
if(mp){{xs=xs.concat(mp.map(p=>p[0]));ys=ys.concat(mp.map(p=>p[1]));}}
const x0=Math.min(...xs),x1=Math.max(...xs),y0=Math.min(...ys),y1=Math.max(...ys);
const s=0.9*Math.min(cv.width/Math.max(x1-x0,1e-6),cv.height/Math.max(y1-y0,1e-6));
const tx=p=>[(p[0]-(x0+x1)/2)*s+cv.width/2, cv.height/2-(p[1]-(y0+y1)/2)*s];
if(mp){{ctx.fillStyle='#444';for(const p of mp){{const[q,r]=tx(p);ctx.fillRect(q,r,1.5,1.5);}}}}
function path(pts,color){{ctx.strokeStyle=color;ctx.lineWidth=2;ctx.beginPath();
pts.forEach((p,i)=>{{const[q,r]=tx(p);i?ctx.lineTo(q,r):ctx.moveTo(q,r);}});ctx.stroke();}}
if(gt)path(gt,'#fa4');path(est,'#4af');
</script></body></html>"""
    with open(path, "w") as f:
        f.write(html)


def voxel_downsample(points: np.ndarray, leaf: float = 0.5) -> np.ndarray:
    """Voxel-grid downsample of an arbitrary cloud: one centroid per leaf
    (the reference's display-map pcl::VoxelGrid with 0.5 m leaves,
    src/radar_odometry.cpp:426-429). Host-side numpy (output size is data
    dependent; display/export concern, not a jit path)."""
    pts = np.asarray(points, dtype=np.float32)
    if len(pts) == 0:
        return pts
    coords = np.floor(pts / leaf).astype(np.int64)
    # unique voxel ids via lexicographic encoding
    _, inv, counts = np.unique(coords, axis=0, return_inverse=True,
                               return_counts=True)
    sums = np.zeros((len(counts), 3), np.float64)
    np.add.at(sums, inv, pts)
    return (sums / counts[:, None]).astype(np.float32)
