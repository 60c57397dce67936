"""Tests: utils/profiling — the tracing/metrics subsystem (SURVEY §5).

aggregate_device_op_ms is validated against synthetic traces laid out like
a jax.profiler capture on a GPU: an XSpace whose "/device:GPU:0" plane
holds kernel events carrying ``hlo_op``/``hlo_module`` stats, plus the
compiled module's HLO text whose stack-frame tables name each op's source
file. A CPU run records no GPU plane, so a real capture can't be made in
the CPU test environment.
"""

import time

import numpy as np
import pytest
from jax.profiler import ProfileData

from chessboard_vision.utils.profiling import (
    FpsCounter,
    StageTimer,
    aggregate_device_op_ms,
    hlo_op_sources,
)

HLO = """HloModule jit_step, is_scheduled=true

FileNames
1 "/src/chessboard_vision/ops/canny.py"
2 "/src/chessboard_vision/ops/color.py"
3 "/src/chessboard_vision/models/pipeline.py"
4 "/src/chessboard_vision/ops/warp.py"

FunctionNames
1 "canny"

FileLocations
1 {file_name_id=1 function_name_id=1 line=42 end_line=42 column=1 end_column=2}
2 {file_name_id=2 function_name_id=1 line=7 end_line=7 column=1 end_column=2}
3 {file_name_id=3 function_name_id=1 line=300 end_line=300 column=1 end_column=2}
4 {file_name_id=4 function_name_id=1 line=9 end_line=9 column=1 end_column=2}

StackFrames
1 {file_location_id=1 parent_frame_id=1}
2 {file_location_id=2 parent_frame_id=1}
3 {file_location_id=3 parent_frame_id=1}
4 {file_location_id=4 parent_frame_id=1}


ENTRY %main.1 (p: f32[4]) -> f32[4] {
  %loop_canny_fusion = f32[4]{0} fusion(%p), kind=kLoop, metadata={op_name="jit(step)/canny" stack_frame_id=1}
  %loop_color_fusion = f32[4]{0} fusion(%p), kind=kLoop, metadata={op_name="jit(step)/mul" stack_frame_id=2}
  %loop_pipe_fusion = f32[4]{0} fusion(%p), kind=kLoop, metadata={op_name="jit(step)/select" stack_frame_id=3}
  ROOT %loop_warp_fusion = f32[4]{0} fusion(%p), kind=kLoop, metadata={op_name="jit(step)/add" stack_frame_id=4}
}
"""


def _write_trace(tmp_path, planes):
    """planes: {plane name: [(kernel name, hlo_op or None, duration us)]}."""
    kinds = sorted({k for evs in planes.values() for k, _, _ in evs})
    text = []
    for pid, (pname, evs) in enumerate(planes.items(), 1):
        events = []
        for kind, op, dur in evs:
            stats = (
                f'stats {{ metadata_id: 1 str_value: "{op}" }} '
                'stats { metadata_id: 2 str_value: "jit_step" }'
                if op else ""
            )
            events.append(
                f"events {{ metadata_id: {kinds.index(kind) + 1} offset_ps: 0 "
                f"duration_ps: {int(dur * 1e6)} {stats} }}"
            )
        meta = " ".join(
            f'event_metadata {{ key: {i} value {{ id: {i} name: "{k}" }} }}'
            for i, k in enumerate(kinds, 1)
        )
        text.append(
            f'planes {{ id: {pid} name: "{pname}" '
            f'lines {{ id: 1 name: "Stream #13(Compute)" {" ".join(events)} }} {meta} '
            'stat_metadata { key: 1 value { id: 1 name: "hlo_op" } } '
            'stat_metadata { key: 2 value { id: 2 name: "hlo_module" } } }'
        )
    d = tmp_path / "plugins" / "profile" / "run1"
    d.mkdir(parents=True)
    (d / "host.xplane.pb").write_bytes(
        ProfileData.text_proto_to_serialized_xspace("\n".join(text))
    )
    return str(tmp_path)


class TestAggregateDeviceOpMs:
    STAGES = {"ops/canny.py": "hough", "ops/color.py": "color"}

    def test_groups_by_stage_and_divides(self, tmp_path):
        td = _write_trace(tmp_path, {
            "/device:GPU:0": [
                ("loop_canny_fusion", "loop_canny_fusion", 4000),
                ("loop_canny_fusion", "loop_canny_fusion", 1000),
                ("loop_color_fusion", "loop_color_fusion", 2000),
                ("loop_warp_fusion", "loop_warp_fusion", 500),  # -> other
            ],
            "/host:CPU": [("loop_canny_fusion", "loop_canny_fusion", 9000)],  # dropped
        })
        got = aggregate_device_op_ms(td, [HLO], stage_of=self.STAGES, per=2)
        assert got == {"hough": 2.5, "color": 1.0, "other": 0.25}
        # ordering: largest stage first
        assert list(got) == ["hough", "color", "other"]

    def test_excludes_callsite_wrappers_and_unnamed(self, tmp_path):
        td = _write_trace(tmp_path, {
            "/device:GPU:0": [
                ("loop_canny_fusion", "loop_canny_fusion", 1000),
                ("loop_pipe_fusion", "loop_pipe_fusion", 8000),  # excluded file
                ("memcpy32_post", None, 7000),  # no HLO op -> other
            ],
        })
        got = aggregate_device_op_ms(
            td, [HLO], stage_of=self.STAGES, exclude_sources=("models/pipeline.py",)
        )
        assert got == {"other": 7.0, "hough": 1.0}

    def test_empty_and_cpu_traces(self, tmp_path):
        with pytest.raises(FileNotFoundError):  # no capture at all
            aggregate_device_op_ms(str(tmp_path / "none"))
        td = _write_trace(tmp_path, {
            "/host:CPU": [("loop_canny_fusion", "loop_canny_fusion", 9000)],
        })
        # A device measurement that recorded no GPU kernel is an error.
        with pytest.raises(RuntimeError):
            aggregate_device_op_ms(td, [HLO], stage_of=self.STAGES)

    def test_hlo_op_sources_reads_stack_frames(self):
        src = hlo_op_sources(HLO)
        assert src["loop_canny_fusion"] == "/src/chessboard_vision/ops/canny.py:42"
        assert src["loop_warp_fusion"] == "/src/chessboard_vision/ops/warp.py:9"
        assert len(src) == 4


class TestCounters:
    def test_fps_counter_window(self):
        c = FpsCounter(window=0.0)  # every update refreshes
        c.update()
        time.sleep(0.01)
        assert c.update() > 0

    def test_stage_timer_percentiles_and_report(self):
        t = StageTimer()
        for ms in (1.0, 2.0, 3.0):
            t.record("infer", ms / 1e3)
        assert np.isclose(t.percentile("infer", 50), 2e-3)
        rep = t.report()
        assert rep["infer"]["n"] == 3
        assert np.isclose(rep["infer"]["p50_ms"], 2.0)
        assert np.isnan(t.percentile("missing", 50))
        with t.stage("timed"):
            pass
        assert t.report()["timed"]["n"] == 1
        t.reset()
        assert t.report() == {}


class TestProfileStepTool:
    def test_cpu_backend_graceful(self):
        """tools/profile_step on a CPU backend says the trace holds no GPU
        kernels and exits 1 instead of printing an empty table."""
        from chessboard_vision.tools import profile_step

        rc = profile_step.main(
            ["--width", "320", "--height", "192", "--steps", "1"]
        )
        assert rc == 1
