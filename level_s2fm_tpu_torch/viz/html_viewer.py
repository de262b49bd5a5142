"""Self-contained interactive HTML viewer for exported reconstructions.

The port's own copy of ``level_s2fm_tpu/viz/html_viewer.py`` (numpy and
json only): loads a run's ``pointcloud.ply``, ``cameras.json`` and the
per-view ``vis/????_*.ply`` dumps and writes one dependency-free HTML
file with the point cloud, the camera frusta and a registration-timeline
slider (canvas orbit controls: drag = rotate, wheel = zoom, shift-drag =
pan). The page is byte for byte the JAX package's for the same inputs.

Usage: python -m level_s2fm_tpu_torch.viz.html_viewer --run output/<run> \
           [--out viewer.html] [--max_points 120000]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np

from ..utils.marching_cubes import read_ply


def camera_frustum_segments(K, W2C, img_hw, scale=0.15) -> np.ndarray:
    """[8,2,3] world-space line segments of a pinhole frustum (apex to the
    4 image corners + far rectangle)."""
    H, W = img_hw
    K = np.asarray(K, np.float64)
    W2C = np.asarray(W2C, np.float64)
    R, t = W2C[:3, :3], W2C[:3, 3]
    C = -R.T @ t
    corners_px = np.asarray([[0, 0], [W, 0], [W, H], [0, H]], np.float64)
    rays = np.linalg.inv(K) @ np.concatenate(
        [corners_px, np.ones((4, 1))], 1).T  # [3,4] cam-space
    far = (R.T @ (rays * scale)).T + C  # [4,3] world
    segs = [[C, far[i]] for i in range(4)]
    segs += [[far[i], far[(i + 1) % 4]] for i in range(4)]
    return np.asarray(segs)


def _collect_timeline(run_dir: str, max_pts_per_step: int) -> List[dict]:
    """Per-view in-training dumps (vis/NNNN_points.ply) as timeline steps,
    each with an embedded (subsampled) snapshot of the growing cloud."""
    vis_dir = os.path.join(run_dir, "vis")
    steps = []
    if os.path.isdir(vis_dir):
        rng = np.random.default_rng(0)
        for f in sorted(os.listdir(vis_dir)):
            if f.endswith(("_points.ply", "_pointcloud.ply")):
                try:
                    pts = np.asarray(read_ply(os.path.join(vis_dir, f))[0],
                                     np.float32).reshape(-1, 3)
                except Exception:
                    continue
                n = len(pts)
                if n > max_pts_per_step:
                    pts = pts[rng.choice(n, max_pts_per_step, replace=False)]
                steps.append({"label": f.split("_")[0], "n": int(n),
                              "points": np.round(pts, 5).tolist()})
    return steps


def export_html(run_dir: str, out_path: Optional[str] = None,
                max_points: int = 120000) -> str:
    pc_path = os.path.join(run_dir, "pointcloud.ply")
    cam_path = os.path.join(run_dir, "cameras.json")
    pts = (read_ply(pc_path)[0] if os.path.exists(pc_path)
           else np.zeros((0, 3)))
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts = pts[sel]
    frusta = []
    if os.path.exists(cam_path):
        with open(cam_path) as f:
            cams = json.load(f)
        for c in cams:
            segs = camera_frustum_segments(c["K"], c["W2C"], c["img_size"])
            frusta.append({"id": c["id"],
                           "segs": np.round(segs, 5).tolist()})
    timeline = _collect_timeline(
        run_dir, max_pts_per_step=max(2000, max_points // 8))

    data = {
        "points": np.round(pts, 5).tolist(),
        "frusta": frusta,
        "timeline": timeline,
    }
    out_path = out_path or os.path.join(run_dir, "viewer.html")
    html = _TEMPLATE.replace("/*__DATA__*/null", json.dumps(data))
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>level_s2fm_tpu viewer</title>
<style>
 body{margin:0;background:#101014;color:#ccc;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:10px;user-select:none}
 #tl{position:fixed;bottom:28px;left:10px;right:10px;display:none}
 #tl input{width:60%;vertical-align:middle}
 canvas{display:block}
</style></head><body>
<div id="hud">level_s2fm_tpu — drag: rotate · wheel: zoom · shift-drag: pan</div>
<div id="tl"><input id="tls" type="range" min="0" max="0" value="0">
 <span id="tll"></span></div>
<canvas id="c"></canvas>
<script>
const DATA = /*__DATA__*/null;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
resize(); addEventListener('resize', ()=>{resize(); draw();});
let pts = DATA.points;
// registration-timeline slider: scrub through per-view training snapshots
const TL = DATA.timeline || [];
if (TL.length){
  const tl=document.getElementById('tl'), s=document.getElementById('tls'),
        lb=document.getElementById('tll');
  tl.style.display='block'; s.max=TL.length; s.value=TL.length;
  const setStep=v=>{
    if (v>=TL.length){pts=DATA.points; lb.textContent='final';}
    else {pts=TL[v].points;
          lb.textContent=`view ${TL[v].label} — ${TL[v].n} pts`;}
    draw();
  };
  s.addEventListener('input', ()=>setStep(+s.value));
  lb.textContent='final';
}
// scene center/extent for the initial view
let cx=0, cy=0, cz=0, n=Math.max(pts.length,1);
for (const p of pts){cx+=p[0];cy+=p[1];cz+=p[2];}
cx/=n; cy/=n; cz/=n;
let ext=1e-6;
for (const p of pts){ext=Math.max(ext,Math.hypot(p[0]-cx,p[1]-cy,p[2]-cz));}
let yaw=0.6, pitch=0.4, dist=3.2*ext, panx=0, pany=0;
function proj(p){
  const x=p[0]-cx, y=p[1]-cy, z=p[2]-cz;
  const cyw=Math.cos(yaw), syw=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  const x1=cyw*x+syw*z, z1=-syw*x+cyw*z;
  const y2=cp*y-sp*z1, z2=sp*y+cp*z1+dist;
  if (z2<=1e-4) return null;
  const f=0.9*Math.min(W,H);
  return [W/2+f*x1/z2+panx, H/2-f*y2/z2+pany, z2];
}
function draw(){
  ctx.fillStyle='#101014'; ctx.fillRect(0,0,W,H);
  // points, depth-shaded
  for (const p of pts){
    const q=proj(p); if(!q) continue;
    const shade=Math.max(60,Math.min(230,230-40*(q[2]/dist)));
    ctx.fillStyle=`rgb(${shade},${shade},${Math.min(255,shade+20)})`;
    ctx.fillRect(q[0], q[1], 2, 2);
  }
  // camera frusta
  ctx.strokeStyle='#e0a040'; ctx.lineWidth=1;
  for (const fr of DATA.frusta){
    for (const s of fr.segs){
      const a=proj(s[0]), b=proj(s[1]); if(!a||!b) continue;
      ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]); ctx.stroke();
    }
    const apex=proj(fr.segs[0][0]);
    if (apex){ctx.fillStyle='#e0a040';ctx.fillText(String(fr.id),apex[0]+4,apex[1]-4);}
  }
  ctx.fillStyle='#888';
  ctx.fillText(`${pts.length} points · ${DATA.frusta.length} cameras`, 10, H-10);
}
let drag=false, px=0, py=0, shift=false;
cv.addEventListener('mousedown', e=>{drag=true;px=e.clientX;py=e.clientY;shift=e.shiftKey;});
addEventListener('mouseup', ()=>drag=false);
addEventListener('mousemove', e=>{
  if(!drag) return;
  const dx=e.clientX-px, dy=e.clientY-py; px=e.clientX; py=e.clientY;
  if (shift){panx+=dx; pany+=dy;} else {yaw+=dx*0.008; pitch+=dy*0.008;}
  draw();
});
cv.addEventListener('wheel', e=>{dist*=Math.exp(e.deltaY*0.001); draw(); e.preventDefault();});
draw();
</script></body></html>
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--max_points", type=int, default=120000)
    args = ap.parse_args(argv)
    out = export_html(args.run, args.out, args.max_points)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
