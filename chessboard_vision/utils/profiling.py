"""Profiling: FPS counters and per-stage latency percentiles.

Replaces the reference's ad-hoc HUD FPS counters (game_session.py:116-121,
frame_enhancer.py:212-215) with recorded metrics: a windowed FPS counter
and a StageTimer that collects per-stage wall times (with
jax.block_until_ready for device stages) and reports p50/p95 — the
BASELINE per-stage latency metrics.
"""

from __future__ import annotations

import glob
import re
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterable, List, NamedTuple

import numpy as np


def card_name_and_limit() -> str:
    """The first GPU's name and power limit as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` gives them, read by a child
    process that stays off JAX; "" where there is no nvidia-smi. A card
    may be held below its top power limit and then runs slower, so every
    number measured on it is reported beside this line."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout
    except FileNotFoundError:
        return ""
    return out.strip().splitlines()[0].strip() if out.strip() else ""


@contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace scope — the framework's tracing hook. The
    ``.xplane.pb`` it writes is read by ``device_op_rows`` /
    ``aggregate_device_op_ms`` (or by TensorBoard's profile plugin)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class DeviceOp(NamedTuple):
    name: str  # kernel name as the trace records it
    source: str  # "path/to/file.py:line" of the HLO op (innermost frame), or ""
    ms: float  # device duration


_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+) = .*?stack_frame_id=(\d+)")
_TABLE_ROW = re.compile(r"^(\d+) (.*)$")


def hlo_op_sources(hlo_text: str) -> Dict[str, str]:
    """HLO instruction name -> "file:line" of its innermost stack frame,
    from the text of a compiled module (``jitted.lower(...).compile()
    .as_text()``): its FileNames / FileLocations / StackFrames tables and
    each instruction's ``stack_frame_id``."""
    files: Dict[int, str] = {}
    locs: Dict[int, tuple] = {}
    frames: Dict[int, int] = {}
    section = None
    ops: Dict[str, str] = {}
    for line in hlo_text.splitlines():
        if line in ("FileNames", "FunctionNames", "FileLocations", "StackFrames"):
            section = line
            continue
        row = _TABLE_ROW.match(line) if section else None
        if row:
            key, body = int(row.group(1)), row.group(2)
            if section == "FileNames":
                files[key] = body.strip('"')
            elif section == "FileLocations":
                fid = int(re.search(r"file_name_id=(\d+)", body).group(1))
                ln = int(re.search(r"line=(\d+)", body).group(1))
                locs[key] = (fid, ln)
            elif section == "StackFrames":
                frames[key] = int(re.search(r"file_location_id=(\d+)", body).group(1))
            continue
        section = None
        m = _INSTR.match(line)
        if m and int(m.group(2)) in frames:
            fid, ln = locs.get(frames[int(m.group(2))], (0, 0))
            if fid in files:
                ops[m.group(1)] = f"{files[fid]}:{ln}"
    return ops


def device_op_rows(trace_dir: str, hlo_texts: Iterable[str] = ()) -> List[DeviceOp]:
    """Every GPU kernel in the newest ``.xplane.pb`` under ``trace_dir``,
    with the source line of the HLO op it ran (looked up by the event's
    ``hlo_op`` stat in ``hlo_texts``; "" when the op is not found).

    Raises if the trace holds no GPU events: a device run that recorded
    no kernel is a broken measurement, not an empty one."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    sources: Dict[str, str] = {}
    for text in hlo_texts:
        sources.update(hlo_op_sources(text))
    rows = []
    for plane in ProfileData.from_file(paths[-1]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op", "")
                rows.append(DeviceOp(ev.name, sources.get(op, ""), ev.duration_ns / 1e6))
    if not rows:
        raise RuntimeError(f"no GPU kernel events in {paths[-1]}")
    return rows


def aggregate_device_op_ms(
    trace_dir: str,
    hlo_texts: Iterable[str] = (),
    stage_of: Dict[str, str] = None,
    per: int = 1,
    exclude_sources: tuple = (),
) -> Dict[str, float]:
    """GPU kernel time from a jax.profiler trace dir, grouped into stages
    by the source file of each kernel's HLO op — the per-stage
    attribution of bench.py's ``per_stage_ms`` extras.

    ``stage_of`` maps source-path suffixes to stage names (unmatched
    kernels land in "other"); ``per`` divides the totals (e.g. the number
    of chained steps in the traced window); ``exclude_sources`` drops
    kernels whose op comes from those files."""
    stage_of = stage_of or {}
    tot: Dict[str, float] = defaultdict(float)
    for row in device_op_rows(trace_dir, hlo_texts):
        src = row.source.rsplit(":", 1)[0]
        if src and any(src.endswith(x) for x in exclude_sources):
            continue
        stage = next((name for suffix, name in stage_of.items() if src.endswith(suffix)), "other")
        tot[stage] += row.ms
    return {k: round(v / per, 4) for k, v in sorted(tot.items(), key=lambda kv: -kv[1])}


class FpsCounter:
    """Windowed FPS: update() per frame; .fps refreshes every ``window`` s."""

    def __init__(self, window: float = 1.0):
        self.window = window
        self._count = 0
        self._start = time.time()
        self.fps = 0.0

    def update(self) -> float:
        self._count += 1
        elapsed = time.time() - self._start
        if elapsed >= self.window:
            self.fps = self._count / elapsed
            self._count = 0
            self._start = time.time()
        return self.fps


class StageTimer:
    """Collects wall-time samples per named stage; reports percentiles."""

    def __init__(self, sync=None):
        self._samples: Dict[str, List[float]] = defaultdict(list)
        self._sync = sync  # e.g. jax.block_until_ready on the stage output

    @contextmanager
    def stage(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        yield
        if self._sync is not None and sync_value is not None:
            self._sync(sync_value)
        self._samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self._samples[name].append(seconds)

    def percentile(self, name: str, q: float) -> float:
        s = self._samples.get(name)
        return float(np.percentile(s, q)) if s else float("nan")

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, s in self._samples.items():
            arr = np.asarray(s)
            out[name] = {
                "n": len(s),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3),
                "mean_ms": float(arr.mean() * 1e3),
            }
        return out

    def reset(self):
        self._samples.clear()
