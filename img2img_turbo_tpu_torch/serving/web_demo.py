"""Standalone sketch / canny demo server on the port's pipeline, no gradio
required (counterpart of `img2img_turbo_tpu/serving/web_demo.py`; the
reference ships its sketch canvas as custom JS inside gradio,
gradio_sketch2image.py:110-209, style.css).

A self-contained standard-library `http.server` app with the same pages
and JSON as the JAX module:

- `GET /`            the canvas UI (pencil, eraser, undo, clear, download,
                     style dropdown, prompt, seed + randomize, r slider)
- `GET /canny`       the canny edge-to-image UI (upload or drop an image,
                     prompt, low / high thresholds 1-255 step 10, re-run on
                     change, inverted edge view + output)
- `POST /api/sketch` {image: dataURL-PNG, prompt, style, seed, r}
                     -> {image: dataURL-PNG} via SketchDemo.run
- `POST /api/canny`  {image, prompt, low, high} -> {edges, image}
                     via CannyDemo.process

An error in a request is answered {"error": "<type>: <message>"} with
status 500, as the JAX server does.
"""

from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from img2img_turbo_tpu_torch.serving.demo import (CannyDemo, SketchDemo,
                                                  STYLE_LIST, DEFAULT_STYLE)

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>img2img-turbo (GPU) sketch demo</title>
<style>
body { font-family: system-ui, sans-serif; margin: 1.5rem; background: #111;
       color: #eee; }
h1 { font-size: 1.2rem; }
.row { display: flex; gap: 1rem; align-items: flex-start; flex-wrap: wrap; }
canvas { background: #fff; border: 1px solid #555; cursor: crosshair;
         touch-action: none; }
button, select, input { background: #222; color: #eee; border: 1px solid
  #555; border-radius: 6px; padding: .4rem .7rem; margin: .15rem; }
button.active { background: #3a6; }
#out { border: 1px solid #555; min-width: 256px; min-height: 256px; }
label { font-size: .85rem; }
#status { color: #8af; font-size: .85rem; }
</style></head><body>
<h1>img2img-turbo — sketch to image (one-step, GPU)</h1>
<div class="row">
  <div>
    <div>
      <button id="pencil" class="active">&#9998; pencil</button>
      <button id="eraser">&#9003; eraser</button>
      <button id="undo">&#8630; undo</button>
      <button id="clear">&#10006; clear</button>
      <button id="dl-sketch">&#8681; sketch</button>
      <button id="dl-output">&#8681; output</button>
    </div>
    <canvas id="canvas" width="512" height="512"></canvas>
  </div>
  <div>
    <img id="out" width="512" height="512" alt="output"/>
    <div id="status"></div>
  </div>
</div>
<div class="row">
  <input id="prompt" size="60" placeholder="prompt"
         value="a cat"/>
  <select id="style">__STYLE_OPTIONS__</select>
  <label>seed <input id="seed" type="number" value="42" style="width:6rem"/>
  </label>
  <button id="rand">&#127922; randomize</button>
  <label>sketch guidance r
    <input id="r" type="range" min="0" max="1" step="0.01" value="0.4"/>
    <span id="rv">0.4</span></label>
  <button id="run">run</button>
</div>
<script>
const cv = document.getElementById('canvas'), ctx = cv.getContext('2d');
ctx.fillStyle = '#fff'; ctx.fillRect(0, 0, cv.width, cv.height);
ctx.lineCap = 'round'; ctx.lineJoin = 'round';
let mode = 'pencil', drawing = false, hist = [];
function snapshot() { hist.push(ctx.getImageData(0,0,cv.width,cv.height));
                      if (hist.length > 40) hist.shift(); }
function pos(e) { const r = cv.getBoundingClientRect();
  const t = e.touches ? e.touches[0] : e;
  return [t.clientX - r.left, t.clientY - r.top]; }
function start(e) { snapshot(); drawing = true;
  ctx.strokeStyle = mode === 'pencil' ? '#000' : '#fff';
  ctx.lineWidth = mode === 'pencil' ? 4 : 24;
  ctx.beginPath(); ctx.moveTo(...pos(e)); e.preventDefault(); }
function move(e) { if (!drawing) return;
  ctx.lineTo(...pos(e)); ctx.stroke(); e.preventDefault(); }
function end() { if (drawing) { drawing = false; schedule(); } }
cv.addEventListener('mousedown', start); cv.addEventListener('mousemove', move);
window.addEventListener('mouseup', end);
cv.addEventListener('touchstart', start); cv.addEventListener('touchmove', move);
cv.addEventListener('touchend', end);
function setMode(m) { mode = m;
  document.getElementById('pencil').classList.toggle('active', m==='pencil');
  document.getElementById('eraser').classList.toggle('active', m==='eraser'); }
document.getElementById('pencil').onclick = () => setMode('pencil');
document.getElementById('eraser').onclick = () => setMode('eraser');
document.getElementById('undo').onclick = () => {
  if (hist.length) { ctx.putImageData(hist.pop(), 0, 0); schedule(); } };
document.getElementById('clear').onclick = () => { snapshot();
  ctx.fillStyle='#fff'; ctx.fillRect(0,0,cv.width,cv.height); schedule(); };
document.getElementById('dl-sketch').onclick = () => {
  const a = document.createElement('a'); a.download = 'sketch.png';
  a.href = cv.toDataURL('image/png'); a.click(); };
document.getElementById('dl-output').onclick = () => {
  const a = document.createElement('a'); a.download = 'output.png';
  a.href = document.getElementById('out').src; a.click(); };
document.getElementById('rand').onclick = () => {
  document.getElementById('seed').value =
    Math.floor(Math.random() * 1e6); schedule(); };
document.getElementById('r').oninput = (e) => {
  document.getElementById('rv').textContent = e.target.value; schedule(); };
document.getElementById('run').onclick = () => go();
let timer = null;
function schedule() { clearTimeout(timer); timer = setTimeout(go, 300); }
async function go() {
  const status = document.getElementById('status');
  status.textContent = 'running...';
  const body = {
    image: cv.toDataURL('image/png'),
    prompt: document.getElementById('prompt').value,
    style: document.getElementById('style').value,
    seed: parseInt(document.getElementById('seed').value) || 0,
    r: parseFloat(document.getElementById('r').value),
  };
  try {
    const resp = await fetch('/api/sketch', {method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify(body)});
    const out = await resp.json();
    if (out.error) { status.textContent = out.error; return; }
    document.getElementById('out').src = out.image;
    status.textContent = '';
  } catch (err) { status.textContent = String(err); }
}
</script></body></html>
"""


_CANNY_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>img2img-turbo (GPU) canny demo</title>
<style>
body { font-family: system-ui, sans-serif; margin: 1.5rem; background: #111;
       color: #eee; }
h1 { font-size: 1.2rem; }
.row { display: flex; gap: 1rem; align-items: flex-start; flex-wrap: wrap; }
.col { display: flex; flex-direction: column; gap: .4rem; }
button, select, input { background: #222; color: #eee; border: 1px solid
  #555; border-radius: 6px; padding: .4rem .7rem; margin: .15rem; }
img.panel { border: 1px solid #555; min-width: 256px; min-height: 256px;
            max-width: 512px; background: #000; }
#drop { border: 2px dashed #555; border-radius: 8px; padding: 2rem;
        text-align: center; color: #aaa; cursor: pointer; }
#drop.hover { border-color: #3a6; color: #3a6; }
label { font-size: .85rem; }
#status { color: #8af; font-size: .85rem; }
a { color: #8af; }
</style></head><body>
<h1>img2img-turbo — canny edge to image (one-step, GPU)
  <a href="/">sketch demo &rarr;</a></h1>
<div class="row">
  <div class="col" style="max-width: 420px">
    <div id="drop">click or drop an image here</div>
    <input id="file" type="file" accept="image/*" style="display:none"/>
    <input id="prompt" size="40" placeholder="prompt"/>
    <label>Canny low threshold
      <input id="low" type="range" min="1" max="255" step="10" value="100"/>
      <span id="lowv">100</span></label>
    <label>Canny high threshold
      <input id="high" type="range" min="1" max="255" step="10" value="200"/>
      <span id="highv">200</span></label>
    <button id="run">run</button>
    <div id="status"></div>
  </div>
  <div class="col"><span>canny edges</span>
    <img id="edges" class="panel" alt="edges"/></div>
  <div class="col"><span>output</span>
    <img id="outimg" class="panel" alt="output"/></div>
</div>
<script>
let dataUrl = null;
const drop = document.getElementById('drop');
const file = document.getElementById('file');
function load(f) { const r = new FileReader();
  r.onload = () => { dataUrl = r.result;
    drop.textContent = f.name + ' (' + f.type + ')'; go(); };
  r.readAsDataURL(f); }
drop.onclick = () => file.click();
file.onchange = () => { if (file.files.length) load(file.files[0]); };
drop.ondragover = (e) => { e.preventDefault(); drop.classList.add('hover'); };
drop.ondragleave = () => drop.classList.remove('hover');
drop.ondrop = (e) => { e.preventDefault(); drop.classList.remove('hover');
  if (e.dataTransfer.files.length) load(e.dataTransfer.files[0]); };
let timer = null;
function schedule() { clearTimeout(timer); timer = setTimeout(go, 300); }
for (const id of ['low', 'high']) {
  document.getElementById(id).oninput = (e) => {
    document.getElementById(id + 'v').textContent = e.target.value;
    schedule(); };  // re-run on threshold change, as the reference does
}
document.getElementById('prompt').onchange = schedule;
document.getElementById('run').onclick = () => go();
async function go() {
  if (!dataUrl) return;
  const status = document.getElementById('status');
  status.textContent = 'running...';
  const body = {
    image: dataUrl,
    prompt: document.getElementById('prompt').value,
    low: parseInt(document.getElementById('low').value),
    high: parseInt(document.getElementById('high').value),
  };
  try {
    const resp = await fetch('/api/canny', {method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify(body)});
    const out = await resp.json();
    if (out.error) { status.textContent = out.error; return; }
    document.getElementById('edges').src = out.edges;
    document.getElementById('outimg').src = out.image;
    status.textContent = '';
  } catch (err) { status.textContent = String(err); }
}
</script></body></html>
"""


def _render_page() -> str:
    opts = "".join(
        f'<option value="{name}"{" selected" if name == DEFAULT_STYLE else ""}>'
        f"{name}</option>" for name, _ in STYLE_LIST)
    return _PAGE.replace("__STYLE_OPTIONS__", opts)


def _decode_data_url(url: str):
    from PIL import Image

    b64 = url.split(",", 1)[1]
    return Image.open(io.BytesIO(base64.b64decode(b64)))


def _encode_data_url(img) -> str:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return ("data:image/png;base64,"
            + base64.b64encode(buf.getvalue()).decode("ascii"))


def make_server(pipe, host: str = "127.0.0.1", port: int = 0,
                mode: str = "sketch") -> ThreadingHTTPServer:
    """Build (not start) the demo HTTP server. port=0 picks a free port."""
    sketch = SketchDemo(pipe)
    canny = CannyDemo(pipe)
    page = _render_page().encode()
    canny_page = _CANNY_PAGE.encode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html", "/canny"):
                body = canny_page if self.path == "/canny" else page
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n))
                img = _decode_data_url(req["image"])
                if self.path == "/api/sketch":
                    out = sketch.run(img, req.get("prompt", ""),
                                     req.get("style", DEFAULT_STYLE),
                                     int(req.get("seed", 0)),
                                     float(req.get("r", 0.4)))
                    self._json({"image": _encode_data_url(out)})
                elif self.path == "/api/canny":
                    edges, out = canny.process(
                        img, req.get("prompt", ""),
                        int(req.get("low", 100)), int(req.get("high", 200)))
                    self._json({"edges": _encode_data_url(edges),
                                "image": _encode_data_url(out)})
                else:
                    self.send_error(404)
            except Exception as e:  # surface errors to the UI
                self._json({"error": f"{type(e).__name__}: {e}"}, code=500)

    return ThreadingHTTPServer((host, port), Handler)


def launch(pipe, host: str = "127.0.0.1", port: int = 7860,
           mode: str = "sketch"):
    """Run the demo server until interrupted (CLI entry point)."""
    server = make_server(pipe, host, port, mode)
    print(f"demo serving on http://{host}:{server.server_address[1]}/")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


def launch_in_thread(pipe, host: str = "127.0.0.1", port: int = 0,
                     mode: str = "sketch"):
    """Start in a daemon thread; returns (server, port) — used by tests."""
    server = make_server(pipe, host, port, mode)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, server.server_address[1]
