"""Interactive viewer: HTTP endpoints drive the progressive renderer.

Covers the reference's interactive surface (FreeViewCamera.cs fly camera
with accumulation auto-reset, DisneyBRDFTest.cs material sliders,
PathTracerGUI.cs editor) through the real server on an ephemeral port.
"""

import json
import time
import urllib.request

import numpy as np
import pytest

from unity_webgpu_pathtracer_tpu.api import Renderer
from unity_webgpu_pathtracer_tpu.config import RenderConfig
from unity_webgpu_pathtracer_tpu.models.cornell import cornell_box
from unity_webgpu_pathtracer_tpu.render.camera import make_camera_params
from unity_webgpu_pathtracer_tpu.viewer import Viewer, serve


def _get(base, path, timeout=30):
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        return r.read(), r.headers.get("Content-Type")


def _post(base, path, obj):
    req = urllib.request.Request(base + path, data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def viewer_server():
    scene, cam = cornell_box()
    size = 24
    config = RenderConfig(width=size, height=size, samples_per_pass=2,
                          max_bounces=2, sky_mode=2, traversal="wide",
                          integrator="fused", pool_size=512)
    params = make_camera_params(width=size, height=size, **cam)
    v = Viewer(Renderer(scene, config, params), cam, max_spp=100000)
    server = serve(v, port=0, block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    yield v, base
    server.shutdown()
    v.stop()


def _wait_spp(base, minimum, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        # A single GET can stall behind a long compile holding the viewer
        # lock (saturated-CPU suite runs) — give it the whole budget.
        state = json.loads(_get(base, "/state", timeout=timeout)[0])
        if state["spp"] >= minimum:
            return state
        time.sleep(0.2)
    raise AssertionError(f"spp never reached {minimum}")


def test_viewer_serves_page_and_frames(viewer_server):
    _v, base = viewer_server
    page, ctype = _get(base, "/")
    assert b"<title>path tracer</title>" in page and ctype == "text/html"
    _wait_spp(base, 2)
    png, ctype = _get(base, "/frame.png")
    assert ctype == "image/png" and png[:8] == b"\x89PNG\r\n\x1a\n"
    from unity_webgpu_pathtracer_tpu.utils.image import read_png
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".png") as f:
        f.write(png)
        f.flush()
        img = read_png(f.name)
    assert img.shape == (24, 24, 3) and img.mean() > 1  # non-black


def test_viewer_camera_edit_resets_accumulation(viewer_server):
    _v, base = viewer_server
    state = _wait_spp(base, 4)
    assert _post(base, "/camera", {"eye": [0.1, 1.0, 3.4]})["ok"]
    # Accumulation restarts (PathTracer.cs:217-222 semantics).
    lo = json.loads(_get(base, "/state")[0])
    assert lo["spp"] <= state["spp"]
    assert lo["cam"]["eye"] == [0.1, 1.0, 3.4]
    _wait_spp(base, 2)  # and keeps rendering afterwards


def test_viewer_material_edit(viewer_server):
    v, base = viewer_server
    state = json.loads(_get(base, "/state")[0])
    assert state["materials"], "cornell scene exposes materials"
    mid = state["materials"][0]["id"]
    assert _post(base, "/material",
                 {"id": mid, "roughness": 0.123,
                  "base_color": [0.9, 0.1, 0.1, 1.0]})["ok"]
    host = v.r._host_scene
    assert host.materials[mid].roughness == pytest.approx(0.123)
    assert host.materials[mid].base_color[0] == pytest.approx(0.9)
    new = json.loads(_get(base, "/state")[0])["materials"][0]
    assert new["roughness"] == pytest.approx(0.123)


def test_viewer_reprojecting_flycam_keeps_history():
    """With reproject=True (CLI --reproject), a small camera move carries
    the accumulated history (per-pixel counts) instead of restarting."""
    scene, cam = cornell_box()
    size = 24
    config = RenderConfig(width=size, height=size, samples_per_pass=2,
                          max_bounces=2, sky_mode=2, traversal="wide",
                          integrator="fused", pool_size=512)
    params = make_camera_params(width=size, height=size, **cam)
    v = Viewer(Renderer(scene, config, params), cam, max_spp=100000,
               reproject=True, max_history=64)
    server = serve(v, port=0, block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        _wait_spp(base, 4)
        eye = list(cam["eye"])
        eye[0] += 0.01
        assert _post(base, "/camera", {"eye": eye})["ok"]
        # The first post-reprojection step recompiles the pass (the film
        # pytree's sample_count changed shape), which can hold the viewer
        # lock for minutes on a loaded CPU — use a generous timeout.
        state = json.loads(_get(base, "/state", timeout=600)[0])
        assert state["spp"] >= 4, "history must survive a tiny fly-cam move"
        counts = np.asarray(v.r.film.sample_count)
        assert counts.shape == (size, size, 1)
        assert (counts[..., 0] > 0).mean() > 0.5
        _wait_spp(base, state["spp"] + 2, timeout=600)
    finally:
        server.shutdown()
        v.stop()


def test_viewer_rejects_unknown_material_field(viewer_server):
    _v, base = viewer_server
    req = urllib.request.Request(
        base + "/material", data=json.dumps({"id": 0, "nope": 1}).encode(),
        method="POST")
    try:
        urllib.request.urlopen(req, timeout=30)
        raise AssertionError("expected 400")
    except urllib.error.HTTPError as e:
        assert e.code == 400
