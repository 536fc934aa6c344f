"""Dependency-free interactive web viewer.

Counterpart of ``neuma_tpu/vis/viewer.py``, which replaces the
reference's viser/nerfview stack (``modules/vis/viewer.py``,
``renderer.py``, ``playback_panel.py``, ``simulation_panel.py``) with a
stdlib HTTP server and an embedded JS frontend: orbit camera (drag and
zoom), playback slider and play/pause, per-object toggles, and a
"Re-Simulate" button that re-runs the rollout with edited settings. The
page (``_PAGE``), the endpoints (``/``, ``/info``, ``/render``,
``/resimulate``, ``/render_path``), their JSON bodies and content types
and the one lock around the instance are the JAX package's. Each request
is answered on its own thread; the instance enters ``torch.no_grad()``
itself. ``/render_path`` writes its video with the port's
``utils/video.py::save_video`` (a GIF where ``imageio`` is absent).

    viewer = DynamicViewer(instance)
    viewer.serve(port=8080)   # open http://localhost:8080
"""
from __future__ import annotations

import io
import json
import threading
from pathlib import Path
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..render.camera import Camera
from .instance import NeuMAInstance

_PAGE = """<!DOCTYPE html>
<html><head><title>NeuMA-TPU Viewer</title><style>
body { margin:0; background:#111; color:#eee; font-family:sans-serif; }
#panel { position:fixed; top:10px; left:10px; background:#222a;
         padding:12px; border-radius:8px; width: 260px; }
#view { display:block; margin:auto; cursor:grab; }
input[type=range] { width: 100%; }
button { margin: 4px 2px; }
</style></head><body>
<img id="view" width="__W__" height="__H__"/>
<div id="panel">
  <div>frame <span id="fidx">0</span>/<span id="fmax">0</span></div>
  <input type="range" id="frame" min="0" max="0" value="0"/>
  <button id="play">play</button>
  <button id="resim">Re-Simulate</button>
  <button id="addkey">+keyframe</button>
  <button id="renderpath">render path</button>
  <span id="nkeys">0 keys</span>
  <div id="pathctl">
    trans <input id="ktrans" type="number" value="0.4" step="0.1"
                 min="0.05" style="width:4em"/>s
    hold <input id="khold" type="number" value="0" step="0.1" min="0"
                style="width:4em"/>s
    fps <input id="kfps" type="number" value="30" min="1"
               style="width:4em"/>
    loop <input id="kloop" type="checkbox"/>
    <button id="clearkeys">clear</button>
  </div>
  <div id="objects"></div>
  <div>drag = orbit, wheel = zoom</div>
</div>
<script>
let az = 0.5, el = 0.3, dist = 2.0, target=[0.5,0.5,0.5];
let frame = 0, playing = false, nframes = 0;
const img = document.getElementById('view');
const slider = document.getElementById('frame');
function eye() {
  return [target[0]+dist*Math.cos(el)*Math.sin(az),
          target[1]+dist*Math.sin(el),
          target[2]-dist*Math.cos(el)*Math.cos(az)];
}
let pending = false;
function refresh() {
  if (pending) return; pending = true;
  const e = eye();
  img.src = `/render?frame=${frame}&ex=${e[0]}&ey=${e[1]}&ez=${e[2]}` +
            `&tx=${target[0]}&ty=${target[1]}&tz=${target[2]}&_=${Date.now()}`;
  img.onload = img.onerror = () => { pending = false; };
  document.getElementById('fidx').textContent = frame;
}
let dragging=false, lx=0, ly=0;
img.onmousedown = e => { dragging=true; lx=e.clientX; ly=e.clientY; };
window.onmouseup = () => dragging=false;
window.onmousemove = e => {
  if (!dragging) return;
  az += (e.clientX-lx)*0.01; el += (e.clientY-ly)*0.01;
  el = Math.max(-1.4, Math.min(1.4, el));
  lx=e.clientX; ly=e.clientY; refresh();
};
img.onwheel = e => { e.preventDefault();
  dist *= (1 + Math.sign(e.deltaY)*0.1);
  dist = Math.max(0.3, Math.min(10, dist)); refresh(); };
slider.oninput = () => { frame = +slider.value; refresh(); };
document.getElementById('play').onclick = () => { playing = !playing; };
setInterval(() => { if (playing && nframes>0) {
  frame = (frame+1)%nframes; slider.value=frame; refresh(); } }, 66);
document.getElementById('resim').onclick = async () => {
  const objects = {};
  document.querySelectorAll('.objbox').forEach(box => {
    const name = box.dataset.name;
    objects[name] = {
      exists: box.querySelector('.objtoggle').checked,
      drop_vel: +box.querySelector('.dropvel').value,
      weight: +box.querySelector('.weight').value,
      adaptor: box.querySelector('.adaptor') ?
               box.querySelector('.adaptor').value : null,
    };
  });
  await fetch('/resimulate', {method:'POST',
    body: JSON.stringify({objects})});
  await info(); refresh();
};
let keyframes = [];
document.getElementById('addkey').onclick = () => {
  // Per-keyframe transition (travel time FROM the previous key) and
  // hold (dwell) captured from the path controls at add time.
  keyframes.push({eye: eye(), target: [...target],
    transition_sec: +document.getElementById('ktrans').value,
    hold_sec: +document.getElementById('khold').value});
  document.getElementById('nkeys').textContent = `${keyframes.length} keys`;
};
document.getElementById('clearkeys').onclick = () => {
  keyframes = [];
  document.getElementById('nkeys').textContent = '0 keys';
};
document.getElementById('renderpath').onclick = async () => {
  if (keyframes.length < 2) { alert('need >= 2 keyframes'); return; }
  const r = await fetch('/render_path', {method:'POST',
    body: JSON.stringify({keyframes, spline: true,
      fps: +document.getElementById('kfps').value,
      loop: document.getElementById('kloop').checked})});
  const d = await r.json();
  alert('path video: ' + d.path);
};
async function info() {
  const r = await fetch('/info'); const d = await r.json();
  nframes = d.num_frames;
  slider.max = Math.max(0, nframes-1);
  document.getElementById('fmax').textContent = nframes-1;
  const div = document.getElementById('objects');
  div.innerHTML = d.objects.map(o => {
    const opts = (d.adaptors || []).map(a =>
      `<option value="${a}" ${a===o.adaptor?'selected':''}>${a}</option>`
    ).join('');
    const dd = d.adaptors && d.adaptors.length ?
      `NeuMA <select class="adaptor">${opts}</select><br/>` : '';
    return `<fieldset class="objbox" data-name="${o.name}">` +
      `<legend>${o.name}</legend>` +
      `Drop Vel <input type="range" class="dropvel" min="0" max="1"` +
      ` step="0.01" value="${o.drop_vel}"/><br/>` +
      `Weight <input type="range" class="weight" min="0" max="1"` +
      ` step="0.01" value="${o.weight}"/><br/>` + dd +
      `<label><input type="checkbox" class="objtoggle"` +
      ` ${o.enabled?'checked':''}/> Object Exists</label>` +
      `</fieldset>`;
  }).join('');
}
info().then(refresh);
</script></body></html>
"""


class DynamicViewer:
    def __init__(
        self,
        instance: NeuMAInstance,
        width: int = 640,
        height: int = 640,
        fov: float = 0.9,
    ):
        self.instance = instance
        self.width = width
        self.height = height
        self.fov = fov
        self._lock = threading.Lock()
        if not instance.frames:
            instance.simulate()

    def _handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parsed = urlparse(self.path)
                if parsed.path == "/":
                    page = _PAGE.replace(
                        "__W__", str(viewer.width)
                    ).replace("__H__", str(viewer.height))
                    self._send(200, "text/html", page.encode())
                elif parsed.path == "/info":
                    body = json.dumps(
                        {
                            "num_frames": len(viewer.instance.frames),
                            "adaptors": sorted(
                                viewer.instance.adaptor_registry
                            ),
                            "objects": [
                                {
                                    "name": o.name,
                                    "enabled": o.enabled,
                                    "drop_vel": o.drop_vel,
                                    "weight": o.lora_weight,
                                    "adaptor": o.adaptor,
                                }
                                for o in viewer.instance.objects
                            ],
                        }
                    ).encode()
                    self._send(200, "application/json", body)
                elif parsed.path == "/render":
                    q = parse_qs(parsed.query)

                    def fget(k, default=0.0):
                        return float(q.get(k, [default])[0])

                    frame = int(fget("frame", 0))
                    eye = np.array(
                        [fget("ex"), fget("ey"), fget("ez")]
                    )
                    target = np.array(
                        [fget("tx"), fget("ty"), fget("tz")]
                    )
                    cam = Camera.look_at(
                        eye=eye,
                        target=target,
                        fov=viewer.fov,
                        width=viewer.width,
                        height=viewer.height,
                    )
                    with viewer._lock:
                        arr = viewer.instance.render_frame(frame, cam)
                    from PIL import Image

                    buf = io.BytesIO()
                    Image.fromarray(arr).save(
                        buf, format="JPEG", quality=90
                    )
                    self._send(200, "image/jpeg", buf.getvalue())
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path == "/render_path":
                    # Camera-path rendering (the equivalent of the
                    # reference's vendored nerfstudio render_panel):
                    # keyframes -> centripetal Catmull-Rom spline with
                    # per-keyframe transition/hold durations and
                    # optional loop (vis/campath.py) -> video, playing
                    # the rollout along the path. Legacy payloads with
                    # only steps_per_segment fall back to pairwise
                    # slerp.
                    length = int(self.headers.get("Content-Length", 0))
                    data = json.loads(self.rfile.read(length) or b"{}")
                    keys = data.get("keyframes", [])
                    use_spline = data.get("spline", True) and len(keys) >= 2
                    if use_spline:
                        from .campath import spline_path

                        poses = spline_path(
                            keys,
                            fps=int(data.get("fps", 30)),
                            default_transition_sec=float(
                                data.get("transition_sec", 0.4)
                            ),
                            loop=bool(data.get("loop", False)),
                            default_fov=viewer.fov,
                        )
                        cams = [
                            Camera.look_at(
                                eye=np.asarray(e),
                                target=np.asarray(t),
                                fov=f,
                                width=viewer.width,
                                height=viewer.height,
                            )
                            for e, t, f in poses
                        ]
                    else:
                        steps = int(data.get("steps_per_segment", 12))
                        cams = []
                        for a, b in zip(keys[:-1], keys[1:]):
                            c1 = Camera.look_at(
                                eye=np.array(a["eye"]),
                                target=np.array(a["target"]),
                                fov=viewer.fov,
                                width=viewer.width,
                                height=viewer.height,
                            )
                            c2 = Camera.look_at(
                                eye=np.array(b["eye"]),
                                target=np.array(b["target"]),
                                fov=viewer.fov,
                                width=viewer.width,
                                height=viewer.height,
                            )
                            cams.extend(Camera.interpolate(c1, c2, steps))
                    import tempfile

                    out_dir = Path(tempfile.mkdtemp(prefix="campath_"))
                    n_frames = max(len(viewer.instance.frames), 1)
                    with viewer._lock:
                        for i, cam in enumerate(cams):
                            arr = viewer.instance.render_frame(
                                i % n_frames, cam
                            )
                            from PIL import Image

                            Image.fromarray(arr).save(
                                out_dir / f"path_{i:04d}.png"
                            )
                    from ..utils.video import save_video

                    video_path = out_dir / "camera_path.mp4"
                    save_video(out_dir, "path_*.png", video_path)
                    # save_video may fall back to .gif
                    produced = (
                        video_path
                        if video_path.exists()
                        else video_path.with_suffix(".gif")
                    )
                    self._send(
                        200,
                        "application/json",
                        json.dumps({"path": str(produced)}).encode(),
                    )
                elif self.path == "/resimulate":
                    # Per-object simulation-panel edits (reference
                    # simulation_panel.py:3-37, viewer.py:117-167):
                    # exists / drop_vel / weight / adaptor. Legacy bool
                    # payloads (existence only) are still accepted.
                    length = int(self.headers.get("Content-Length", 0))
                    data = json.loads(self.rfile.read(length) or b"{}")
                    edits = data.get("objects", {})
                    with viewer._lock:
                        for name, settings in edits.items():
                            if isinstance(settings, bool):
                                settings = {"exists": settings}
                            viewer.instance.apply_object_settings(
                                name, settings
                            )
                        viewer.instance.simulate()
                    self._send(200, "application/json", b"{}")
                else:
                    self._send(404, "text/plain", b"not found")

        return Handler

    def serve(self, port: int = 8080, blocking: bool = True):
        server = ThreadingHTTPServer(("0.0.0.0", port), self._handler())
        print(f"NeuMA-TPU viewer at http://localhost:{port}")
        if blocking:
            server.serve_forever()
        thread = threading.Thread(
            target=server.serve_forever, daemon=True
        )
        thread.start()
        return server
