"""Browser GUI for the headless viewer (stdlib HTTP server).

Counterpart of trase_tpu/viewer_web.py (reference gui.py /
gui_standalone.py, the dearpygui desktop apps): a single-page app with
drag-to-orbit, scroll-zoom, a time slider, all seven render modes
(gui.py:672-677), K-Means / HDBSCAN buttons (gui.py:248-319), click-prompt
selection (gui.py:754-839), the score-threshold post-filter
(gui.py:456-464), removal preview (gui.py:414-417, 1070), save-object
(gui.py:617-651), the trajectory overlay and the per-frame ms / FPS
readout (gui.py:1104-1124).

Start with:  python -m trase_tpu_torch.viewer -m <model_path> --serve 8000
then open http://localhost:8000/.

Every state-changing interaction is a POST /cmd {cmd, ...} JSON call;
frames are fetched as JPEG from /frame.jpg. Requests run on the
server's threads; one lock serializes every call into the single
HeadlessViewer, so its device work (the compositor kernel on the card
included) is issued by one thread at a time.
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .viewer import MODES, HeadlessViewer

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>trase_tpu_torch viewer</title>
<style>
 body { margin:0; font:13px system-ui, sans-serif; background:#16181d;
        color:#d8dce3; display:flex; height:100vh; }
 #panel { width:240px; padding:12px; background:#1e2128; overflow-y:auto; }
 #panel h3 { margin:10px 0 4px; font-size:12px; color:#8b93a2;
             text-transform:uppercase; letter-spacing:.06em; }
 #stage { flex:1; display:flex; align-items:center; justify-content:center; }
 #view { max-width:100%; max-height:100%; cursor:grab; user-select:none;
         -webkit-user-drag:none; }
 select, input[type=number], button {
   width:100%; margin:2px 0; padding:5px 6px; background:#2a2e37;
   color:#d8dce3; border:1px solid #3a3f4b; border-radius:4px; }
 button:hover { background:#343945; cursor:pointer; }
 input[type=range] { width:100%; }
 #status { font-size:11px; color:#8b93a2; white-space:pre-line; }
 label.row { display:flex; align-items:center; gap:6px; margin:4px 0; }
 label.row input { width:auto; margin:0; }
</style></head><body>
<div id="panel">
 <h3>Mode</h3>
 <select id="mode"></select>
 <h3>Time</h3>
 <input type="range" id="time" min="0" max="1" step="0.01" value="0">
 <h3>Clustering</h3>
 <button onclick="cmd({cmd:'cluster'})">HDBSCAN cluster</button>
 <button onclick="cmd({cmd:'cluster', kmeans:true,
   k:+document.getElementById('kk').value})">K-Means cluster</button>
 <input type="number" id="kk" value="64" title="K for K-Means">
 <h3>Selection</h3>
 <label class="row"><input type="checkbox" id="selmode">
   click selects object</label>
 <label class="row">score thr
   <input type="number" id="thr" value="0.8" step="0.05" min="0" max="1"
    onchange="cmd({cmd:'threshold', value:+this.value})"></label>
 <button onclick="cmd({cmd:'clear'})">clear selection</button>
 <label class="row"><input type="checkbox" id="removal"
   onchange="cmd({cmd:'removal', on:this.checked})">render removal</label>
 <label class="row"><input type="checkbox" id="traj"
   onchange="cmd({cmd:'trajectory', on:this.checked})">visualize
   trajectory</label>
 <button onclick="cmd({cmd:'save_object'})">save object ply</button>
 <button onclick="cmd({cmd:'save_rest'})">save rest ply</button>
 <h3>Status</h3>
 <div id="status">…</div>
</div>
<div id="stage"><img id="view" draggable="false"></div>
<script>
const img = document.getElementById('view');
const modeSel = document.getElementById('mode');
let state = {};
async function cmd(body) {
  const r = await fetch('/cmd', {method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify(body)});
  state = await r.json();
  document.getElementById('status').textContent =
    (state.msg ? state.msg + '\\n' : '') +
    `${(state.ms||0).toFixed(1)} ms (${(state.fps||0).toFixed(1)} FPS)` +
    `\\nclusters: ${state.n_clusters ?? '—'}` +
    `\\nselected: [${state.selected ?? ''}]`;
  refresh();
}
function refresh() { img.src = '/frame.jpg?t=' + Date.now(); }
fetch('/modes').then(r=>r.json()).then(ms=>{
  for (const m of ms) {
    const o = document.createElement('option'); o.textContent = m;
    modeSel.appendChild(o);
  }
  modeSel.onchange = () => cmd({cmd:'mode', name:modeSel.value});
  cmd({cmd:'noop'});
});
document.getElementById('time').oninput = e =>
  cmd({cmd:'time', fid:+e.target.value});
let drag = null;
img.addEventListener('pointerdown', e => {
  drag = {x:e.clientX, y:e.clientY, moved:false, pan:e.shiftKey};
  img.setPointerCapture(e.pointerId);
});
img.addEventListener('pointermove', e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  if (Math.abs(dx) + Math.abs(dy) < 2) return;
  drag.moved = true; drag.x = e.clientX; drag.y = e.clientY;
  cmd(drag.pan ? {cmd:'pan', dx, dy} : {cmd:'orbit', dx, dy});
});
img.addEventListener('pointerup', e => {
  if (drag && !drag.moved && document.getElementById('selmode').checked) {
    const r = img.getBoundingClientRect();
    cmd({cmd:'click',
         px: (e.clientX - r.left) * img.naturalWidth / r.width,
         py: (e.clientY - r.top) * img.naturalHeight / r.height});
  }
  drag = null;
});
img.addEventListener('wheel', e => {
  e.preventDefault(); cmd({cmd:'zoom', delta: e.deltaY > 0 ? -1 : 1});
}, {passive:false});
</script></body></html>"""


class ViewerServer:
    """HTTP wrapper around one HeadlessViewer; thread-safe."""

    def __init__(self, viewer: HeadlessViewer):
        self.viewer = viewer
        self.lock = threading.Lock()
        self.removal = False
        self._httpd = None

    # ------------------------------------------------------------- api

    def state(self, msg: str = "") -> dict:
        v = self.viewer
        n_clusters = (int(v.cluster_ids.max()) + 1
                      if v.cluster_ids is not None else None)
        ms = v.last_frame_ms
        return {
            "ok": True,
            "msg": str(msg),
            "mode": v.mode,
            "fid": float(v.fid),
            "threshold": float(v.score_threshold),
            "removal": bool(self.removal),
            "n_clusters": None if n_clusters is None else int(n_clusters),
            "selected": [int(c) for c in v.selected_clusters],
            "ms": None if ms != ms else float(ms),  # NaN -> null
            "fps": 0.0 if ms != ms or not ms else 1000.0 / float(ms),
        }

    def frame_jpeg(self, quality: int = 90) -> bytes:
        from PIL import Image

        with self.lock:
            img = self.viewer.render_frame(
                apply_selection_removal=self.removal)
        arr = (np.clip(img.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=quality)
        return buf.getvalue()

    def command(self, body: dict) -> dict:
        v = self.viewer
        cmd = body.get("cmd", "noop")
        msg = ""
        with self.lock:
            if cmd == "orbit":
                v.cam.orbit(float(body["dx"]), float(body["dy"]))
            elif cmd == "zoom":
                v.cam.scale(float(body["delta"]))
            elif cmd == "pan":
                v.cam.pan(float(body["dx"]), float(body["dy"]))
            elif cmd == "time":
                v.fid = float(body["fid"])
            elif cmd == "mode":
                name = body["name"]
                if name not in MODES:
                    raise ValueError(f"unknown mode {name!r}")
                v.mode = name
            elif cmd == "cluster":
                v.cluster(kmeans=bool(body.get("kmeans", False)),
                          k=int(body.get("k", 64)),
                          save=v.model_dir is not None)
                msg = "clustered"
            elif cmd == "click":
                cid = v.click_select(float(body["px"]), float(body["py"]))
                msg = (f"selected cluster {cid}" if cid is not None
                       else "no geometry under click")
            elif cmd == "text":
                ids = v.text_select(text=body.get("prompt"),
                                    threshold=int(body.get("count", 500)))
                msg = f"text prompt -> clusters {ids}"
            elif cmd == "threshold":
                v.score_threshold = float(body["value"])
                v._recompute_mask()
            elif cmd == "clear":
                v.clear_selection()
                self.removal = False
            elif cmd == "removal":
                self.removal = bool(body.get("on", True))
            elif cmd == "trajectory":
                on = v.toggle_trajectory(on=body.get("on"))
                msg = f"trajectory overlay {'on' if on else 'off'}"
            elif cmd == "save_object":
                msg = f"wrote {v.save_object(body.get('path'))}"
            elif cmd == "save_rest":
                msg = f"wrote {v.save_without_object(body.get('path'))}"
            elif cmd == "noop":
                pass
            else:
                raise ValueError(f"unknown cmd {cmd!r}")
        return self.state(msg)

    # ---------------------------------------------------------- server

    def serve(self, port: int = 8000, host: str = "127.0.0.1",
              block: bool = True):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, payload: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                path = urlparse(self.path).path
                try:
                    if path == "/":
                        self._send(200, "text/html; charset=utf-8",
                                   _PAGE.encode())
                    elif path == "/modes":
                        self._send(200, "application/json",
                                   json.dumps(list(MODES)).encode())
                    elif path == "/frame.jpg":
                        q = parse_qs(urlparse(self.path).query)
                        quality = int(q.get("q", ["90"])[0])
                        self._send(200, "image/jpeg",
                                   server.frame_jpeg(quality))
                    elif path == "/state":
                        self._send(200, "application/json",
                                   json.dumps(server.state()).encode())
                    else:
                        self._send(404, "text/plain", b"not found")
                except Exception as e:  # surface errors to the client
                    self._send(500, "application/json", json.dumps(
                        {"ok": False, "error": str(e)}).encode())

            def do_POST(self):
                if urlparse(self.path).path != "/cmd":
                    self._send(404, "text/plain", b"not found")
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    self._send(200, "application/json",
                               json.dumps(server.command(body)).encode())
                except Exception as e:
                    self._send(500, "application/json", json.dumps(
                        {"ok": False, "error": str(e)}).encode())

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        actual = self._httpd.server_address[1]
        print(f"[viewer_web] serving on http://{host}:{actual}/", flush=True)
        if block:
            try:
                self._httpd.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                self._httpd.server_close()
        else:
            t = threading.Thread(target=self._httpd.serve_forever,
                                 daemon=True)
            t.start()
        return actual

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
