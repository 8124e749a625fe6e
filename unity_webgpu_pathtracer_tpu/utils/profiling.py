"""Profiling & observability.

The reference instruments with CommandBuffer profiler samples, wall-clock
Debug.Log timings, per-ray traversal step counters, and the Graphy overlay
(SURVEY.md §5).  Equivalents here:

* :class:`Timer` — wall-clock scopes with ``block_until_ready`` semantics;
* :class:`RenderStats` — per-pass rays/arrivals/occupancy aggregation fed by
  the fused integrator's on-device counters (the ``hit.steps`` analogue);
* :func:`trace` — a ``jax.profiler`` trace context for deep dives, and
  :func:`hlo_layers` / :func:`device_kernel_events` / :func:`layer_times`,
  which reduce a GPU trace to device time per integrator layer;
* :func:`scene_summary` — the structured scene-stat logging that
  ``BVHScene`` emits via Debug.Log (tri/material/texture/instance counts).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import time

import jax
import numpy as np


class Timer:
    """Wall-clock scope that synchronizes device work on exit."""

    def __init__(self, name: str, sync_on=None, log=print):
        self.name = name
        self.sync_on = sync_on
        self.log = log
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync_on is not None:
            jax.block_until_ready(self.sync_on)
        self.elapsed = time.perf_counter() - self._t0
        if self.log:
            self.log(f"[timer] {self.name}: {self.elapsed * 1e3:.1f} ms")
        return False


@dataclasses.dataclass
class RenderStats:
    """Accumulated render telemetry across passes."""

    rays: int = 0
    arrivals: int = 0
    seconds: float = 0.0
    occupancy_sum: float = 0.0
    passes: int = 0

    def update(self, rays, arrivals, occupancy, seconds) -> None:
        self.rays += int(rays)
        self.arrivals += int(arrivals)
        self.occupancy_sum += float(occupancy)
        self.seconds += seconds
        self.passes += 1

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / max(self.seconds, 1e-9) / 1e6

    @property
    def occupancy(self) -> float:
        return self.occupancy_sum / max(self.passes, 1)

    def summary(self) -> str:
        return (f"{self.rays:,} rays in {self.seconds:.2f}s "
                f"({self.mrays_per_sec:.2f} Mrays/s), "
                f"{self.arrivals:,} BVH arrivals, "
                f"occupancy {self.occupancy:.2f}")


@contextlib.contextmanager
def trace(log_dir: str):
    """``jax.profiler`` trace scope (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def scene_summary(scene_data) -> dict:
    """Structured scene statistics (the BVHScene Debug.Log block)."""
    return {
        "triangles": int(scene_data.tris.shape[0]),
        "materials": int(scene_data.materials.shape[0]),
        "texture_words": int(scene_data.texture_data.shape[0]),
        "lights": int(scene_data.lights.shape[0]),
        "instances": int(scene_data.inst_l2w.shape[0]),
        "wide_rows": int(scene_data.wide_nodes.shape[1])
        if scene_data.wide_nodes.size > 48 else 0,
        "env_resolution": tuple(int(x) for x in scene_data.env.image.shape[:2]),
        "hbm_bytes": int(sum(np.prod(x.shape) * x.dtype.itemsize
                             for x in jax.tree.leaves(scene_data))),
    }


# ---------------------------------------------------------------------------
# Trace -> per-layer device time.  The fused integrator wraps its layers in
# ``jax.named_scope`` ("arrival", "transition", "prestep"); every compiled
# kernel is attributed to a layer through the op_name metadata of the
# compiled HLO, and its device events are summed per layer.
# ---------------------------------------------------------------------------

LAYERS = ("arrival", "transition", "prestep")

_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s+->\s+.*\{\s*$")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s+=\s+(.*)$")
_OPNAME_RE = re.compile(r'op_name="([^"]*)"')
_CALLS_RE = re.compile(r"(?:calls|to_apply|body|condition)=%?([\w.\-]+)")


def _norm(name: str) -> str:
    return re.sub(r"[.\-]", "_", name)


def _layer_of(op_name: str, layers) -> str | None:
    parts = op_name.split("/")
    for layer in layers:
        if layer in parts:
            return layer
    return None


def hlo_layers(hlo_text: str, layers=LAYERS) -> dict:
    """Map each instruction of compiled HLO text to a layer.

    An instruction takes the layer named in its own ``op_name``; a fusion
    or call whose own metadata names none takes the most common layer of
    the computation it calls.  Keys are instruction names normalized the
    way kernel names are (``.`` and ``-`` become ``_``); unattributed
    instructions are left out."""
    comp_votes: dict = {}
    instrs = []                          # (name, own layer, called comps)
    comp = None
    for line in hlo_text.splitlines():
        m = _COMP_RE.match(line)
        if m:
            comp = m.group(1)
            continue
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, rest = m.groups()
        op = _OPNAME_RE.search(rest)
        layer = _layer_of(op.group(1), layers) if op else None
        instrs.append((name, layer, _CALLS_RE.findall(rest)))
        if layer is not None and comp is not None:
            votes = comp_votes.setdefault(comp, {})
            votes[layer] = votes.get(layer, 0) + 1
    out = {}
    for name, layer, calls in instrs:
        if layer is None:
            votes: dict = {}
            for c in calls:
                for k, v in comp_votes.get(c, {}).items():
                    votes[k] = votes.get(k, 0) + v
            if votes:
                layer = max(votes, key=votes.get)
        if layer is not None:
            out[_norm(name)] = layer
    return out


def device_kernel_events(xspace_path: str, plane_prefix="/device:GPU",
                         line_prefix="Stream") -> list:
    """``(kernel name, hlo_op, start_ns, duration_ns)`` of every kernel
    the GPU ran, from a ``jax.profiler`` ``.xplane.pb`` file.

    Only per-stream kernel lines are read (the derived "XLA Ops" /
    "XLA Modules" lines repeat the same time).  The prefixes select other
    planes and lines (the CPU backend's ops sit on ``/host:CPU``,
    ``tf_XLA...`` threads)."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xspace_path)
    events = []
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            if not line.name.startswith(line_prefix):
                continue
            for e in line.events:
                stats = dict(e.stats)
                events.append((e.name, str(stats.get("hlo_op", e.name)),
                               float(e.start_ns), float(e.duration_ns)))
    return events


def layer_times(events, layer_of: dict, layers=LAYERS) -> dict:
    """Per-layer device seconds, launch counts and the busy window.

    ``layer_of`` is :func:`hlo_layers`' map.  Returns ``{"layers": {layer:
    {"s", "launches", "per_op_launches"}}, "busy_s", "window_s",
    "idle_share", "other_s"}``; busy is the union of kernel intervals."""
    acc = {k: {"s": 0.0, "launches": 0, "per_op_launches": {}}
           for k in layers}
    other = 0.0
    spans = []
    for name, hlo_op, start, dur in events:
        spans.append((start, start + dur))
        # Kernels replayed from a CUDA graph carry hlo_op "command_buffer";
        # their kernel name is then the fusion's name.
        key = next((k for k in (_norm(hlo_op), _norm(name)) if k in layer_of),
                   None)
        if key is None:
            other += dur * 1e-9
            continue
        a = acc[layer_of[key]]
        a["s"] += dur * 1e-9
        a["launches"] += 1
        a["per_op_launches"][key] = a["per_op_launches"].get(key, 0) + 1
    busy = 0.0
    end_prev = None
    for s, e in sorted(spans):
        if end_prev is None or s > end_prev:
            busy += e - s
            end_prev = e
        elif e > end_prev:
            busy += e - end_prev
            end_prev = e
    window = (max(e for _, e in spans) - min(s for s, _ in spans)) if spans else 0.0
    return {"layers": acc, "other_s": other, "busy_s": busy * 1e-9,
            "window_s": window * 1e-9,
            "idle_share": 1.0 - busy / window if window > 0 else None}


def loop_iterations(layer_stats: dict) -> int:
    """Super-iterations in a traced fused pass: the most common launch
    count among one layer's kernels (each runs once per iteration)."""
    counts = list(layer_stats["per_op_launches"].values())
    if not counts:
        return 0
    return max(set(counts), key=counts.count)
