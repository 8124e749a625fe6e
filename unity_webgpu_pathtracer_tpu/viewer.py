"""Interactive web viewer: fly camera + live material editing.

The interactive surface the reference spreads across its example scripts,
re-hosted as a dependency-free local web app (the framework is headless;
a browser is the portable "editor window"):

- ``FreeViewCamera.cs:1-50`` — WASD + mouse-drag fly camera; accumulation
  auto-resets on camera change exactly like the reference's per-frame
  camera-matrix check (``PathTracer.cs:217-222``), here explicit via
  ``Renderer.update_camera``.
- ``DisneyBRDFTest.cs:49-89`` — material sliders pushing parameter edits
  into the running render (``UpdateMaterialData`` analogue =
  ``Renderer.update_material``).
- ``PathTracerGUI.cs:7-14`` — the (stub) custom material editor.
- ``Bounce.cs:1-18`` — optional instance animation on TLAS scenes
  (TLAS-only refit per frame via ``update_instance_transform``).

Architecture: one render thread steps the progressive Renderer under a
lock; HTTP handler threads (stdlib ``ThreadingHTTPServer``) apply edits
and encode frames under the same lock. All device work stays serialized,
so this composes with jit exactly like the batch CLI.

Endpoints: ``GET /`` (app), ``GET /frame.png`` (current tonemapped
frame), ``GET /state`` (spp + camera + materials JSON),
``POST /camera {eye, target, fov_y_deg}``, ``POST /material {id, ...}``,
``POST /bounce {on}``.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from unity_webgpu_pathtracer_tpu.config import PostParams
from unity_webgpu_pathtracer_tpu.utils.image import encode_png

_SLIDER_FIELDS = (
    # The 12 DisneyBRDFTest.cs sliders (:49-89), same parameter names.
    "metallic", "roughness", "ior", "transmission", "anisotropic",
    "specular", "specular_tint", "sheen", "sheen_tint", "subsurface",
    "clearcoat", "clearcoat_gloss",
)


class Viewer:
    """Progressive render loop + edit queue around a ``Renderer``."""

    def __init__(self, renderer, cam: dict, post: PostParams = PostParams(mode=1),
                 max_spp: int = 4096, bounce: bool = False,
                 reproject: bool = False, max_history: int = 256,
                 tiered_start: bool = True):
        self.r = renderer
        self.cam = dict(cam)
        self.post = post
        self.max_spp = max_spp
        self.bounce = bounce
        # Fly-cam moves warp accumulated history instead of restarting
        # (render/reproject.py); disocclusions restart per pixel.
        self.reproject = reproject
        self.max_history = max_history
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.passes = 0
        # Live runtime stats (Graphy analogue, GraphyManager.cs:32):
        # EMA of seconds/pass measured around the blocking step, plus the
        # renderer's last-pass occupancy/ray count.
        self.pass_s = 0.0
        self.rays_per_s = 0.0
        # Cold-start tiering: the production fused executable unrolls its
        # te arrivals, while the arrival_fori variant iterates one arrival
        # in a fori_loop — a smaller graph that compiles faster.  Start the
        # render loop on the fori executable and swap to the production
        # config once its compile (cached or fresh) lands in the
        # background — the reference's passthrough-until-ready frame loop
        # (PathTracer.cs:188-194).  Both executables run the same per-lane
        # arithmetic, so accumulation carries across the swap.  Whether
        # the tiering pays on the GPU is not measured.
        self.tiered = (tiered_start
                       and renderer.config.integrator == "fused"
                       and not getattr(renderer.config, "arrival_fori",
                                       False))
        self._prod_config = renderer.config
        if self.tiered:
            self.r.config = dataclasses.replace(renderer.config,
                                                arrival_fori=True)

    # -- render loop ---------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        if self.tiered:
            threading.Thread(target=self._warm_production,
                             daemon=True).start()

    def _warm_production(self) -> None:
        """Compile the production (non-fori) executable in the background,
        then swap the render loop onto it.  The explicit lower().compile()
        lands the executable in the persistent compilation cache (enabled
        by serve()/Renderer), so the swapped loop's first step is a disk
        deserialize, not a recompile."""
        from unity_webgpu_pathtracer_tpu.render.fused import (
            fused_pass_and_accumulate,
        )

        try:
            with self.lock:
                args = (self.r.scene, self._prod_config, self.r.params,
                        self.r.film)
            fused_pass_and_accumulate.lower(*args).compile()
        except Exception:
            return  # stay on the fori executable (still correct, -30%)
        if self._stop.is_set():
            return
        with self.lock:
            self.r.config = self._prod_config
            self.tiered = False

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def _loop(self) -> None:
        t0 = time.time()
        while not self._stop.is_set():
            with self.lock:
                if self.bounce and self.r._host_scene is not None \
                        and self.r._host_scene.instances:
                    phase = 2.0 * np.pi * (time.time() - t0) / 4.0
                    scene = self.r._host_scene
                    for i in range(max(len(scene.instances) - 1, 0)):
                        _mid, tr0, _m = scene.instances[i]
                        tr = np.array(tr0, np.float32).copy()
                        tr[1, 3] = 0.4 + abs(np.sin(phase + i)) * 1.2
                        self.r.update_instance_transform(i, tr)
                if self.r.sample_count < self.max_spp:
                    t1 = time.perf_counter()
                    self.r.step()
                    if self.r.last_rays is not None:
                        self.r.last_rays.block_until_ready()
                    dt = time.perf_counter() - t1
                    self.passes += 1
                    ema = 0.3 if self.pass_s else 1.0
                    self.pass_s += ema * (dt - self.pass_s)
                    st = self.r.stats()
                    if st and self.pass_s > 0:
                        self.rays_per_s = st["rays"] / self.pass_s
                        self._occ = st.get("occupancy", 0.0)
                    work = True
                else:
                    work = False
            if not work:
                time.sleep(0.05)

    # -- edits (called from HTTP handler threads) ----------------------
    def set_camera(self, eye=None, target=None, fov_y_deg=None) -> None:
        from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params

        with self.lock:
            if eye is not None:
                self.cam["eye"] = tuple(float(x) for x in eye)
            if target is not None:
                self.cam["target"] = tuple(float(x) for x in target)
            if fov_y_deg is not None:
                self.cam["fov_y_deg"] = float(fov_y_deg)
            params = make_camera_params(
                width=self.r.config.width, height=self.r.config.height,
                **self.cam)
            # Reprojected fly-cam: carry converged history through the
            # move; falls back to the reference's full reset when off.
            self.r.update_camera(params, reproject=self.reproject,
                                 max_history=self.max_history)

    def set_material(self, material_id: int, **fields) -> None:
        with self.lock:
            host = self.r._require_host_scene()
            desc = host.materials[material_id]
            clean = {}
            for k, v in fields.items():
                if not hasattr(desc, k):
                    raise KeyError(k)
                cur = getattr(desc, k)
                clean[k] = tuple(float(x) for x in v) \
                    if isinstance(cur, tuple) else type(cur)(v)
            self.r.update_material(material_id, dataclasses.replace(desc, **clean))

    # -- reads ---------------------------------------------------------
    def frame_png(self) -> bytes:
        with self.lock:
            return encode_png(self.r.image(self.post))

    def state(self) -> dict:
        with self.lock:
            host = self.r._host_scene
            mats = [
                {"id": i,
                 "base_color": list(m.base_color[:3]),
                 **{f: getattr(m, f) for f in _SLIDER_FIELDS}}
                for i, m in enumerate(host.materials if host else [])
            ]
            return {"spp": int(self.r.sample_count), "passes": self.passes,
                    "cam": {k: list(v) if isinstance(v, tuple) else v
                            for k, v in self.cam.items()},
                    "width": self.r.config.width,
                    "height": self.r.config.height,
                    "bounce": self.bounce,
                    "stats": {"pass_s": round(self.pass_s, 3),
                              "mrays_per_s": round(self.rays_per_s / 1e6, 2),
                              "occupancy": round(getattr(self, "_occ", 0.0), 3),
                              "tier": "fori" if self.tiered else "production"},
                    "materials": mats}


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>path tracer</title><style>
body{margin:0;display:flex;font:13px system-ui;background:#191b1f;color:#d8dade}
#view{flex:1;display:flex;align-items:center;justify-content:center;min-height:100vh}
#img{image-rendering:pixelated;max-width:90%;max-height:95vh;outline:1px solid #333}
#panel{width:270px;padding:12px;background:#22252a;overflow-y:auto;height:100vh;box-sizing:border-box}
label{display:block;margin:6px 0 0}input[type=range]{width:100%}
#spp{color:#7a8}select,button{width:100%;margin:4px 0}
.hint{color:#778;font-size:11px}
</style></head><body>
<div id="view"><img id="img" tabindex="0"></div>
<div id="panel">
  <div id="spp">–</div>
  <div class="hint">click image, then WASD+QE to fly, drag to look</div>
  <label>material <select id="mat"></select></label>
  <div id="sliders"></div>
  <label>base color <input type="color" id="color" value="#cccccc"></label>
  <button id="bounce">toggle bounce</button>
</div>
<script>
const FIELDS = %FIELDS%;
let cam=null, mats=[], cur=0, yaw=0, pitch=0, dist=1;
const img=document.getElementById('img');
function refresh(){ img.src='/frame.png?t='+Date.now(); }
img.onload=()=>setTimeout(refresh, 250); img.onerror=()=>setTimeout(refresh, 1000);
async function post(u,b){ await fetch(u,{method:'POST',body:JSON.stringify(b)}); }
function vsub(a,b){return a.map((x,i)=>x-b[i]);} function vadd(a,b){return a.map((x,i)=>x+b[i]);}
function dirFrom(yaw,pitch){return [Math.cos(pitch)*Math.sin(yaw),Math.sin(pitch),-Math.cos(pitch)*Math.cos(yaw)];}
async function state(){
  const s=await (await fetch('/state')).json();
  let t=s.spp+' spp';
  if(s.stats && s.stats.pass_s>0){
    t+=' · '+s.stats.pass_s.toFixed(2)+' s/pass · '+s.stats.mrays_per_s.toFixed(1)
      +' Mrays/s · occ '+s.stats.occupancy.toFixed(2)
      +(s.stats.tier=='fori'?' · warming…':'');
  }
  document.getElementById('spp').textContent=t;
  if(!cam){ cam=s.cam; const d=vsub(cam.target,cam.eye);
    dist=Math.hypot(...d); yaw=Math.atan2(d[0],-d[2]); pitch=Math.asin(d[1]/dist);
    mats=s.materials; const sel=document.getElementById('mat');
    sel.innerHTML=mats.map(m=>`<option value="${m.id}">material ${m.id}</option>`).join('');
    buildSliders(); }
  setTimeout(state, 2000);
}
function buildSliders(){
  const div=document.getElementById('sliders'); const m=mats[cur]; if(!m) return;
  div.innerHTML=FIELDS.map(f=>`<label>${f} <span id="v_${f}">${m[f].toFixed(2)}</span>
    <input type="range" id="s_${f}" min="0" max="${f=='ior'?3:1}" step="0.01" value="${m[f]}"></label>`).join('');
  FIELDS.forEach(f=>{ document.getElementById('s_'+f).oninput=e=>{
    const v=parseFloat(e.target.value); document.getElementById('v_'+f).textContent=v.toFixed(2);
    mats[cur][f]=v; post('/material',{id:cur,[f]:v}); };});
}
document.getElementById('mat').onchange=e=>{cur=+e.target.value; buildSliders();};
document.getElementById('color').oninput=e=>{
  const h=e.target.value; const rgb=[1,3,5].map(i=>parseInt(h.substr(i,2),16)/255);
  post('/material',{id:cur,base_color:[...rgb,1]});};
document.getElementById('bounce').onclick=()=>post('/bounce',{toggle:true});
let drag=false,lx=0,ly=0;
img.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;img.focus();};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{ if(!drag||!cam) return;
  yaw+=(e.clientX-lx)*0.005; pitch-=(e.clientY-ly)*0.005;
  pitch=Math.max(-1.5,Math.min(1.5,pitch)); lx=e.clientX; ly=e.clientY;
  cam.target=vadd(cam.eye,dirFrom(yaw,pitch).map(x=>x*dist));
  post('/camera',{eye:cam.eye,target:cam.target}); };
window.onkeydown=e=>{ if(!cam) return; const sp=0.15;
  const fwd=dirFrom(yaw,pitch), right=[Math.cos(yaw),0,Math.sin(yaw)];
  const mv={'w':fwd,'s':fwd.map(x=>-x),'d':right,'a':right.map(x=>-x),
            'e':[0,1,0],'q':[0,-1,0]}[e.key]; if(!mv) return;
  cam.eye=vadd(cam.eye,mv.map(x=>x*sp));
  cam.target=vadd(cam.eye,dirFrom(yaw,pitch).map(x=>x*dist));
  post('/camera',{eye:cam.eye,target:cam.target}); };
state(); refresh();
</script></body></html>"""


def make_handler(viewer: Viewer):
    page = _PAGE.replace("%FIELDS%", json.dumps(list(_SLIDER_FIELDS))).encode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                if self.path.startswith("/frame.png"):
                    self._send(200, viewer.frame_png(), "image/png")
                elif self.path.startswith("/state"):
                    self._send(200, json.dumps(viewer.state()).encode())
                elif self.path == "/" or self.path.startswith("/index"):
                    self._send(200, page, "text/html")
                else:
                    self._send(404, b"{}")
            except BrokenPipeError:
                pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            try:
                if self.path.startswith("/camera"):
                    viewer.set_camera(body.get("eye"), body.get("target"),
                                      body.get("fov_y_deg"))
                elif self.path.startswith("/material"):
                    mid = int(body.pop("id"))
                    viewer.set_material(mid, **body)
                elif self.path.startswith("/bounce"):
                    with viewer.lock:
                        viewer.bounce = bool(body.get("on",
                                                      not viewer.bounce))
                else:
                    return self._send(404, b"{}")
                self._send(200, b'{"ok": true}')
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, json.dumps({"error": str(e)}).encode())

    return Handler


def serve(viewer: Viewer, host: str = "127.0.0.1", port: int = 8000,
          block: bool = True) -> ThreadingHTTPServer:
    """Start the render loop and the HTTP server (port 0 = ephemeral)."""
    from unity_webgpu_pathtracer_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()  # warm-start recompiles (idempotent, opt-out-able)
    server = ThreadingHTTPServer((host, port), make_handler(viewer))
    viewer.start()
    if block:
        try:
            server.serve_forever()
        finally:
            viewer.stop()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
