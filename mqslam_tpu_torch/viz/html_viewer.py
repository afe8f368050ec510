"""Self-contained HTML 3D viewer for trajectories + point-cloud maps.

The reference visualized results in Blender — camera-trajectory import,
colored point clouds, and a modal file-listener for live updates while
slam2 runs (reference: Work/python_libs/blender_tools.py:206-320
create_cam_trajectory, :447-499 import_points_from_pcd_file, :501-596
run_file_listener; viewport point rendering blender_view3D_pointclouds.py).
This module replaces that with a dependency-free artifact: ONE .html file
with an embedded canvas renderer (drag to orbit, wheel to zoom, WASD pan)
— no external JS, works offline. Two modes:

- ``export_viewer(out_html, points, colors, trajectory)``: data embedded
  as JSON in the file.
- ``export_live_viewer(out_html, traj_file, map_file, period_s)``: the
  page polls the TUM/PCD files (relative paths, serve the output dir with
  ``python -m http.server``) and re-renders — the run_file_listener role
  for watching a live slam_run.
"""

import json
import os

import numpy as np

__all__ = ["export_viewer", "export_live_viewer"]

_RENDER_JS = r"""
const cv = document.getElementById('c');
const ctx = cv.getContext('2d');
let yaw = -0.6, pitch = 0.5, dist = D0, cx = C0[0], cy = C0[1], cz = C0[2];
let drag = false, lx = 0, ly = 0;
cv.onmousedown = e => { drag = true; lx = e.clientX; ly = e.clientY; };
window.onmouseup = () => drag = false;
window.onmousemove = e => {
  if (!drag) return;
  yaw += (e.clientX - lx) * 0.008; pitch += (e.clientY - ly) * 0.008;
  pitch = Math.max(-1.55, Math.min(1.55, pitch));
  lx = e.clientX; ly = e.clientY; render();
};
cv.onwheel = e => { dist *= Math.exp(e.deltaY * 0.001); render();
                    e.preventDefault(); };
window.onkeydown = e => {
  const s = dist * 0.05;
  if (e.key === 'w') cz += s; if (e.key === 's') cz -= s;
  if (e.key === 'a') cx -= s; if (e.key === 'd') cx += s;
  if (e.key === 'q') cy -= s; if (e.key === 'e') cy += s;
  render();
};
function render() {
  const W = cv.width, H = cv.height;
  ctx.fillStyle = '#101018'; ctx.fillRect(0, 0, W, H);
  const cyaw = Math.cos(yaw), syaw = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const f = Math.min(W, H);
  function proj(p) {
    let x = p[0] - cx, y = p[1] - cy, z = p[2] - cz;
    let x1 = cyaw * x + syaw * z, z1 = -syaw * x + cyaw * z;
    let y2 = cp * y - sp * z1, z2 = sp * y + cp * z1 + dist;
    if (z2 <= 0.05) return null;
    return [W / 2 + f * x1 / z2, H / 2 + f * y2 / z2, z2];
  }
  const img = ctx.getImageData(0, 0, W, H), d = img.data;
  for (let i = 0; i < PTS.length; i += 6) {
    const q = proj([PTS[i], PTS[i + 1], PTS[i + 2]]);
    if (!q) continue;
    const xi = q[0] | 0, yi = q[1] | 0;
    if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
    const o = 4 * (yi * W + xi);
    d[o] = PTS[i + 3]; d[o + 1] = PTS[i + 4]; d[o + 2] = PTS[i + 5];
    d[o + 3] = 255;
  }
  ctx.putImageData(img, 0, 0);
  ctx.strokeStyle = '#66aaff'; ctx.lineWidth = 1.5; ctx.beginPath();
  let started = false;
  for (let i = 0; i < TRAJ.length; i += 3) {
    const q = proj([TRAJ[i], TRAJ[i + 1], TRAJ[i + 2]]);
    if (!q) { started = false; continue; }
    if (!started) { ctx.moveTo(q[0], q[1]); started = true; }
    else ctx.lineTo(q[0], q[1]);
  }
  ctx.stroke();
  if (TRAJ.length >= 3) {
    const q = proj(TRAJ.slice(TRAJ.length - 3));
    if (q) { ctx.fillStyle = '#ffcc44';
             ctx.fillRect(q[0] - 3, q[1] - 3, 6, 6); }
  }
  ctx.fillStyle = '#ccc'; ctx.font = '12px monospace';
  ctx.fillText(`${PTS.length / 6} points  ${TRAJ.length / 3} poses  ` +
               'drag: orbit  wheel: zoom  wasd/qe: pan', 8, H - 8);
}
render();
"""

_LIVE_JS = r"""
function parseTUM(text) {
  const out = [];
  for (const line of text.split('\n')) {
    if (!line || line[0] === '#') continue;
    const v = line.trim().split(/\s+/).map(Number);
    if (v.length >= 4) out.push(v[1], v[2], v[3]);
  }
  return out;
}
function parsePCD(text) {
  const lines = text.split('\n');
  let i = 0, n = 0;
  for (; i < lines.length; i++) {
    if (lines[i].startsWith('POINTS')) n = +lines[i].split(/\s+/)[1];
    if (lines[i].startsWith('DATA')) { i++; break; }
  }
  const out = [];
  for (; i < lines.length; i++) {
    const v = lines[i].trim().split(/\s+/).map(Number);
    if (v.length < 3 || !isFinite(v[0])) continue;
    let r = 200, g = 200, b = 200;
    if (v.length >= 4) {
      const buf = new ArrayBuffer(4);
      new Float32Array(buf)[0] = v[3];
      const u = new Uint8Array(buf);
      b = u[0]; g = u[1]; r = u[2];
    }
    out.push(v[0], v[1], v[2], r, g, b);
  }
  return out;
}
async function poll() {
  try {
    const [tt, mt] = await Promise.all([
      fetch(TRAJ_FILE + '?t=' + Date.now()).then(r => r.text()),
      MAP_FILE ? fetch(MAP_FILE + '?t=' + Date.now()).then(r => r.text())
               : Promise.resolve(null)]);
    TRAJ = parseTUM(tt);
    if (mt !== null) PTS = parsePCD(mt);
    render();
  } catch (e) { /* file not there yet */ }
  setTimeout(poll, PERIOD_MS);
}
poll();
"""

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>mqslam viewer</title>
<style>body{{margin:0;background:#101018}}canvas{{display:block}}</style>
</head><body>
<canvas id="c" width="1280" height="800"></canvas>
<script>
let PTS = {pts_json};
let TRAJ = {traj_json};
const D0 = {d0};
const C0 = {c0};
{extra}
{render_js}
{live_js}
</script></body></html>
"""


def _pack(points, colors):
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    if colors is None:
        colors = np.full((len(pts), 3), 200, np.uint8)
    colors = np.asarray(colors)
    if colors.ndim == 1:
        g = np.clip(colors, 0, 255).astype(np.uint8)
        colors = np.stack([g, g, g], 1)
    inter = np.concatenate([pts, colors[:, :3].astype(np.float64)], axis=1)
    return inter.reshape(-1)


def _view_init(points, traj_locs):
    all_pts = [p for p in (points, traj_locs) if p is not None and len(p)]
    if not all_pts:
        return 10.0, [0.0, 0.0, 0.0]
    cat = np.concatenate([np.asarray(p).reshape(-1, 3) for p in all_pts])
    c = cat.mean(0)
    d = max(float(np.linalg.norm(cat - c, axis=1).max()) * 2.2, 1.0)
    return d, [float(x) for x in c]


def export_viewer(out_html, points, colors=None, trajectory=None):
    """Write a standalone HTML viewer with the data embedded.

    points [N, 3]; colors [N, 3] uint8 or [N] intensity or None;
    trajectory: CamTrajectory or [M, 3] locations or None.
    """
    traj_locs = None
    if trajectory is not None:
        traj_locs = np.asarray(getattr(trajectory, "locations", trajectory),
                               np.float64).reshape(-1, 3)
    d0, c0 = _view_init(points, traj_locs)
    page = _PAGE.format(
        pts_json=json.dumps([round(float(v), 5)
                             for v in _pack(points, colors)]),
        traj_json=json.dumps(
            [] if traj_locs is None else
            [round(float(v), 5) for v in traj_locs.reshape(-1)]),
        d0=d0, c0=json.dumps(c0), extra="", render_js=_RENDER_JS,
        live_js="")
    with open(out_html, "w") as f:
        f.write(page)
    return out_html


def export_live_viewer(out_html, traj_file, map_file=None,
                       period_s: float = 1.0):
    """Write a polling viewer next to a running slam_run's output files.

    traj_file/map_file are paths RELATIVE to the html file (same dir in
    the common case). Serve the directory (``python -m http.server``) and
    open the page; it re-reads the files every ``period_s`` — the
    blender_tools.run_file_listener live-results loop (:501-596).
    """
    extra = (f"const TRAJ_FILE = {json.dumps(traj_file)};\n"
             f"const MAP_FILE = {json.dumps(map_file)};\n"
             f"const PERIOD_MS = {int(period_s * 1000)};")
    page = _PAGE.format(pts_json="[]", traj_json="[]", d0=10.0,
                        c0="[0,0,0]", extra=extra, render_js=_RENDER_JS,
                        live_js=_LIVE_JS)
    with open(out_html, "w") as f:
        f.write(page)
    return out_html
