"""Live drive/observability server — the reference web_nav.py's LIVE half.

The reference serves a Flask app on :8765 with an MJPEG camera feed, a 2-D
map with the robot trail, click-to-drive goals (via /tmp/isaac_goal.txt),
and STOP/reset controls (simulation/isaac/tools/web_nav.py:1-503).  Our
rollout is one jitted program, so the live equivalent runs it in short
chunks and exposes the carry between chunks:

- 2-D map canvas: scene colliders + teach WPs + live GT/nav trails
- camera feed: the depth raycaster's current frame, rendered to PNG
  (the honest analog of the reference's RGB MJPEG — our sensor IS depth)
- click-to-drive: a map click replaces the dispatcher's waypoint list with
  the clicked goal, driven through the REAL planner + follower stack
- STOP/GO + "remove obstacles" (fires the turnaround supervisor's drop
  mask manually, like the reference's /tmp flag file)

    python -m nclt_slam_tpu.cli.live --route 03_south --port 8765
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PAGE = """<!DOCTYPE html>
<html><head><title>nclt_slam_tpu live</title>
<style>
 body { font-family: sans-serif; margin: 1.2em; background: #111; color: #eee; }
 canvas { border: 1px solid #444; background: #181818; cursor: crosshair; }
 img { border: 1px solid #444; image-rendering: pixelated; }
 button { margin: 0 4px; padding: 6px 14px; font-size: 14px; }
 #hud { font-family: monospace; white-space: pre; margin: 8px 0; }
</style></head>
<body>
<h3>nclt_slam_tpu — live drive</h3>
<div>
 <button onclick="post('/ctl',{cmd:'stop'})">STOP</button>
 <button onclick="post('/ctl',{cmd:'go'})">GO</button>
 <button onclick="post('/ctl',{cmd:'fire'})">remove obstacles</button>
 <span style="color:#888">click the map to drive there</span>
</div>
<div id="hud">connecting…</div>
<canvas id="cv" width="980" height="500"></canvas>
<img id="cam" width="320" height="240" src="/depth.png" style="vertical-align:top; margin-left:10px">
<script>
let scene = null, view = null;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
function post(url, body) { fetch(url, {method:'POST', body: JSON.stringify(body)}); }
function w2c(p) { return [20+(p[0]-view[0])*view[4], cv.height-20-(p[1]-view[2])*view[4]]; }
cv.onclick = e => {
  if (!view) return;
  const r = cv.getBoundingClientRect();
  const x = (e.clientX-r.left-20)/view[4]+view[0];
  const y = (cv.height-20-(e.clientY-r.top))/view[4]+view[2];
  post('/goal', {x: x, y: y});
};
async function tick() {
  try {
    if (!scene) scene = await (await fetch('/scene.json')).json();
    const s = await (await fetch('/state.json')).json();
    const xs = scene.bounds;
    view = [xs[0], xs[1], xs[2], xs[3],
            Math.min((cv.width-40)/(xs[1]-xs[0]), (cv.height-40)/(xs[3]-xs[2]))];
    ctx.clearRect(0,0,cv.width,cv.height);
    for (const o of scene.obstacles) {
      const [cx, cy] = w2c(o); ctx.beginPath();
      ctx.fillStyle = o[3] ? (s.fired ? '#333' : '#a33') : '#555';
      ctx.arc(cx, cy, Math.max(2, o[2]*view[4]), 0, 7); ctx.fill();
    }
    ctx.fillStyle = '#3a3';
    for (const p of scene.wps) { const [cx,cy]=w2c(p); ctx.fillRect(cx-2,cy-2,4,4); }
    for (const [trail, color] of [[s.gt, '#58a6ff'], [s.nav, '#ffa657']]) {
      if (!trail.length) continue;
      ctx.beginPath(); ctx.strokeStyle = color; ctx.lineWidth = 1.5;
      ctx.moveTo(...w2c(trail[0]));
      for (const p of trail) ctx.lineTo(...w2c(p));
      ctx.stroke();
    }
    if (s.goal) { const [cx,cy]=w2c(s.goal); ctx.strokeStyle='#f5f'; ctx.lineWidth=2;
      ctx.beginPath(); ctx.arc(cx,cy,8,0,7); ctx.stroke(); }
    if (s.gt.length) { const [cx,cy]=w2c(s.gt[s.gt.length-1]);
      ctx.fillStyle='#fff'; ctx.beginPath(); ctx.arc(cx,cy,5,0,7); ctx.fill(); }
    document.getElementById('hud').textContent =
      `t=${(s.tick*0.1).toFixed(1)}s  wp ${s.wp_idx}/${s.n_wps}  drift=${s.drift.toFixed(2)}m` +
      `  regime=${['no_anchor','ok','strong','encoder','gt'][s.regime] ?? s.regime}` +
      `  v=${s.v.toFixed(2)}  ${s.running ? (s.paused ? 'PAUSED' : 'RUNNING') : 'DONE'}`;
    document.getElementById('cam').src = '/depth.png?' + s.tick;
  } catch (e) { document.getElementById('hud').textContent = 'server gone: '+e; }
  setTimeout(tick, 500);
}
tick();
</script></body></html>"""


class LiveState:
    """Shared state between the rollout loop and the HTTP handlers."""

    def __init__(self):
        self.lock = threading.Lock()
        self.scene_blob = b"{}"
        self.state_blob = b"{}"
        self.depth_png = b""
        self.goal = None          # (x, y) pending click
        self.paused = False
        self.fire = False


def _handler(live: LiveState):
    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, blob, ctype="application/json"):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/":
                self._send(PAGE.encode(), "text/html")
            elif self.path == "/scene.json":
                self._send(live.scene_blob)
            elif self.path == "/state.json":
                self._send(live.state_blob)
            elif self.path.startswith("/depth.png"):
                self._send(live.depth_png or b"", "image/png")
            else:
                self.send_error(404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            with live.lock:
                if self.path == "/goal":
                    live.goal = (float(body["x"]), float(body["y"]))
                elif self.path == "/ctl":
                    cmd = body.get("cmd")
                    if cmd == "stop":
                        live.paused = True
                    elif cmd == "go":
                        live.paused = False
                    elif cmd == "fire":
                        live.fire = True
            self._send(b"{}")

    return H


def _png_gray(img) -> bytes:
    """(H, W) uint8 -> 8-bit grayscale PNG bytes (zlib + numpy, no PIL)."""
    import struct
    import zlib

    h, w = img.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def _depth_png(depth, dvalid, cfg):
    """Depth frame -> 320x240 grayscale PNG bytes (near bright, far dark,
    nearest-neighbour upscaled)."""
    import numpy as np

    d = np.asarray(depth, np.float32)
    v = np.asarray(dvalid)
    g = np.where(v, 1.0 - np.clip(d / cfg.camera.depth_max, 0, 1), 0.0)
    rows = np.arange(240) * g.shape[0] // 240
    cols = np.arange(320) * g.shape[1] // 320
    img = (g[rows[:, None], cols[None, :]] * 255).astype(np.uint8)
    return _png_gray(np.ascontiguousarray(img))


def inject_goal(carry, goal_xy, cfg):
    """Click-to-drive: replace the dispatcher's remaining waypoint list with
    the clicked goal (the reference writes /tmp/isaac_goal.txt and its
    dispatcher retargets; ours retargets the REAL hybrid dispatcher)."""
    import jax.numpy as jnp

    d = carry.dispatch
    W = d.wps.shape[0]
    g = jnp.tile(jnp.asarray(goal_xy, jnp.float32)[None, :], (W, 1))
    d = d._replace(
        wps=g, wps_proj=g, n_wps=jnp.int32(1), idx=jnp.int32(0),
        target=jnp.asarray(goal_xy, jnp.float32),
        skip=jnp.zeros(W, bool), ticks_on_wp=jnp.int32(0),
        plan_fails=jnp.int32(0), done=jnp.array(False),
        reached_count=jnp.int32(0), skipped_count=jnp.int32(0))
    return carry._replace(dispatch=d)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--route", default="03_south")
    ap.add_argument("--mode", default="ours")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address; set 0.0.0.0 to expose the control "
                         "endpoints beyond this machine")
    ap.add_argument("--ticks", type=int, default=12000)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--teach-ticks", type=int, default=9000)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--obstacles", action="store_true", default=True)
    ap.add_argument("--no-obstacles", dest="obstacles", action="store_false")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--max-chunks", type=int, default=None,
                    help="(testing) stop after N chunks")
    args = ap.parse_args(argv)

    from nclt_slam_tpu.runtime import init_runtime

    init_runtime(args.platform)

    import jax

    import jax.numpy as jnp
    import numpy as np

    from nclt_slam_tpu.cli.common import config_for
    from nclt_slam_tpu.dynamics.diffdrive import robot_pose3d
    from nclt_slam_tpu.landmarks.store import init_store
    from nclt_slam_tpu.rollout.campaign import (
        build_campaign,
        run_campaign_teach,
        teach_waypoints,
    )
    from nclt_slam_tpu.rollout.repeat import init_repeat_carry, run_repeat
    from nclt_slam_tpu.sensors.depth import render_depth

    cfg = config_for(args.mode, args.scale)
    cfg_teach = config_for("gt", args.scale)

    live = LiveState()
    srv = ThreadingHTTPServer((args.host, args.port), _handler(live))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    print(f"[live] http://{args.host}:{args.port}  route={args.route} "
          f"mode={args.mode}", flush=True)

    import jax.tree_util as jtu

    data = build_campaign([args.route], cfg=cfg, with_drops=args.obstacles)
    print("[live] teaching…", flush=True)
    teach = run_campaign_teach(data, cfg_teach, args.teach_ticks)
    wps, n_wps = teach_waypoints(data, teach, cfg_teach)

    sc = jtu.tree_map(lambda x: x[0], data.scenes_repeat)
    rt = jtu.tree_map(lambda x: x[0], data.routes)
    grid = teach.teach_grid[0]
    store = jtu.tree_map(lambda x: x[0], teach.store) \
        if args.mode != "gt" else init_store(cfg.landmarks)
    wps0, n0 = wps[0], n_wps[0]

    # scene blob (once)
    obs = [[float(x), float(y), float(r), int(dm)]
           for (x, y), r, v, dm in zip(
               np.asarray(sc.xy), np.asarray(sc.radius),
               np.asarray(sc.valid), np.asarray(sc.drop_mask)) if v]
    wp_list = np.asarray(wps0)[: int(n0)].tolist()
    pts = np.asarray([o[:2] for o in obs] + wp_list)
    bounds = [float(pts[:, 0].min() - 5), float(pts[:, 0].max() + 5),
              float(pts[:, 1].min() - 5), float(pts[:, 1].max() + 5)]
    live.scene_blob = json.dumps(
        {"obstacles": obs, "wps": wp_list, "bounds": bounds}).encode()

    carry = init_repeat_carry(rt, wps0, n0, cfg)
    depth_fn = jax.jit(lambda pos3, yaw, valid: render_depth(
        pos3, yaw, sc.xy, sc.radius, sc.base_z, sc.height, valid,
        cfg.camera))

    gt_trail, nav_trail = [], []
    tick0 = 0
    chunks = 0
    goal = None
    print("[live] driving (chunked)…", flush=True)
    while tick0 < args.ticks:
        with live.lock:
            paused = live.paused
            if live.goal is not None:
                goal = live.goal
                live.goal = None
                carry = inject_goal(carry, goal, cfg)
            if live.fire:
                live.fire = False
                carry = carry._replace(sup=carry.sup._replace(
                    fired=jnp.array(True)))
        if paused:
            import time as _t

            # surface the parked state so clients (and the stop test) can
            # distinguish "parked between chunks" from "chunk in flight"
            with live.lock:
                if live.state_blob:
                    st = json.loads(live.state_blob)
                    if not st.get("paused"):
                        st["paused"] = True
                        live.state_blob = json.dumps(st).encode()
            _t.sleep(0.3)
            continue

        res = run_repeat(sc, rt, grid, wps0, n0, cfg, args.chunk,
                         store=store, carry=carry, tick0=tick0)
        carry = res.final
        tick0 += args.chunk
        chunks += 1

        tr = res.trace
        gt = np.asarray(tr.gt_xy)
        nav = np.asarray(tr.nav_xy)
        gt_trail.extend(gt[::5].tolist())
        nav_trail.extend(nav[::5].tolist())
        pos3, _ = robot_pose3d(carry.robot)
        valid_now = sc.valid & (~(sc.drop_mask & carry.sup.fired))
        depth, _, dvalid = depth_fn(pos3, carry.robot.yaw, valid_now)
        live.depth_png = _depth_png(depth, dvalid, cfg)
        state = {
            "tick": tick0,
            "gt": gt_trail[-2000:], "nav": nav_trail[-2000:],
            "wp_idx": int(tr.wp_idx[-1]), "n_wps": int(n0),
            "drift": float(np.hypot(*(nav[-1] - gt[-1]))),
            "regime": int(tr.regime[-1]) if int(tr.regime[-1]) >= 0 else 4,
            "v": float(tr.cmd_v[-1]),
            "fired": bool(tr.fired[-1]),
            "goal": list(goal) if goal else None,
            "running": True, "paused": False,
        }
        live.state_blob = json.dumps(state).encode()
        if bool(tr.done[-1]) and goal is None:
            print("[live] route complete", flush=True)
            break
        if args.max_chunks and chunks >= args.max_chunks:
            break

    state = json.loads(live.state_blob or b"{}")
    state["running"] = False
    live.state_blob = json.dumps(state).encode()
    print("[live] rollout finished; server stays up (ctrl-c to exit)",
          flush=True)
    if args.max_chunks:
        srv.shutdown()
        return 0
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
