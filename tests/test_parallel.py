"""Tests: device noise FSM (differential vs host NoiseHandler), batched
multi-stream pipeline, and mesh sharding over the 8 virtual CPU devices."""

import numpy as np
import jax
import jax.numpy as jnp

from chessboard_vision.ops import fsm as fsm_ops
from chessboard_vision.session.noise import NoiseHandler, NoiseState
from chessboard_vision.parallel import make_mesh, MultiStreamPipeline
from chessboard_vision.parallel.mesh import stream_sharding
from chessboard_vision import geometry as geo
from chessboard_vision.models.pipeline import occupancy_to_set

from fixtures import make_board_frame, initial_occupancy, DEFAULT_CORNERS

MODE_OF = {
    NoiseState.IDLE: fsm_ops.MODE_IDLE,
    NoiseState.NOISE_ACTIVE: fsm_ops.MODE_NOISE,
    NoiseState.MOVE_PENDING: fsm_ops.MODE_PENDING,
}


def mask_of(squares):
    m = np.zeros(64, bool)
    for f, r in squares:
        m[r * 8 + f] = True
    return m


class TestDeviceNoiseFsm:
    def test_differential_vs_host_random_sequences(self, rng):
        """Drive both FSMs with 300 random change-sets; states must agree."""
        step = jax.jit(fsm_ops.noise_step)
        for trial in range(4):
            host = NoiseHandler()
            dev = fsm_ops.init_state()
            for t in range(300):
                k = rng.integers(0, 10)
                if k < 4:
                    changed = set()
                elif k < 7:
                    n = int(rng.integers(1, 4))
                    changed = {(int(rng.integers(0, 8)), int(rng.integers(0, 8))) for _ in range(n)}
                else:
                    n = int(rng.integers(4, 10))
                    changed = {(int(rng.integers(0, 8)), int(rng.integers(0, 8))) for _ in range(n)}
                h_state, h_data = host.process(changed)
                dev, out = step(dev, jnp.asarray(mask_of(changed)))
                assert int(dev.mode) == MODE_OF[host.state], f"trial {trial} t {t}"
                assert int(dev.stable_count) == host.stable_count
                h_fired = h_data.get("stable", False) or h_data.get("message") == "move_ready"
                assert bool(out.stable) == bool(h_fired), (trial, t, h_data)
                if h_fired:
                    got = {(s % 8, s // 8) for s in np.where(np.asarray(out.squares))[0]}
                    assert got == h_data["squares"]
                # lifted-square parity (incl. the noise->pending refresh)
                h_lift = host.last_lifted_square
                d_lift = int(dev.lifted)
                want = -1 if h_lift is None else h_lift[1] * 8 + h_lift[0]
                assert d_lift == want, (trial, t, h_lift, d_lift, h_data)

    def test_lifted_tracking(self):
        dev = fsm_ops.init_state()
        dev, out = fsm_ops.noise_step(dev, jnp.asarray(mask_of({(4, 1)})))
        assert int(out.lifted) == 1 * 8 + 4
        dev, out = fsm_ops.noise_step(dev, jnp.asarray(mask_of({(4, 1), (4, 3)})))
        assert int(out.lifted) == -1


class TestMultiStream:
    def test_batched_streams_match_singles(self, rng):
        """4 streams with different positions; batched outputs equal the
        single-stream pipeline run on each."""
        g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
        n = 4
        ms = MultiStreamPipeline(g, n_streams=n)
        state = ms.init_state()

        occs = []
        frames0 = []
        for i in range(n):
            occ = initial_occupancy()
            if i % 2:
                occ[4, 1] = False
                occ[4, 3] = True
            occs.append(occ)
            frames0.append(make_board_frame(occ, rng))
        frames0 = np.stack(frames0)
        state = ms.capture_reference(state, frames0)

        frames1 = np.stack([make_board_frame(occ, rng) for occ in occs])
        state, out = ms.step(state, frames1)
        for i in range(n):
            truth = {(f, r) for f in range(8) for r in range(8) if occs[i][f, r]}
            assert occupancy_to_set(np.asarray(out.step.occupancy[i])) == truth, i

    def test_per_stream_geometries_match_independent_pipelines(self, rng):
        """Two streams with DIFFERENT corner calibrations in one batched
        step: outputs must equal two independent VisionPipelines, each
        built on its own geometry."""
        from chessboard_vision.models.pipeline import VisionPipeline
        from chessboard_vision.ops import static_resample as sr
        from fixtures import make_board_frame

        corners_a = DEFAULT_CORNERS
        corners_b = DEFAULT_CORNERS + np.array([[14, 9], [-11, 6], [8, -7], [-12, -10]])
        geos = [
            geo.BoardGeometry.from_calibration(corners_a),
            geo.BoardGeometry.from_calibration(corners_b),
        ]
        occ_a = initial_occupancy()
        occ_b = initial_occupancy()
        occ_b[4, 1] = False
        occ_b[4, 3] = True

        f0 = [
            make_board_frame(occ_a, rng, corners=corners_a),
            make_board_frame(occ_b, rng, corners=corners_b),
        ]
        f1 = [
            make_board_frame(occ_a, rng, corners=corners_a),
            make_board_frame(occ_b, rng, corners=corners_b),
        ]

        ms = MultiStreamPipeline(geos, n_streams=2)
        state = ms.capture_reference(ms.init_state(), np.stack(f0))
        state, out = ms.step(state, np.stack(f1))

        for i, (g, occ) in enumerate(zip(geos, (occ_a, occ_b))):
            pipe = VisionPipeline(g, donate_state=False)
            st = pipe.capture_reference(pipe.init_state(), sr.to_planar(f0[i]))
            st, o = pipe.step(st, sr.to_planar(f1[i]))
            assert np.array_equal(
                np.asarray(out.step.occupancy[i]), np.asarray(o.occupancy)
            ), f"stream {i} occupancy"
            assert np.array_equal(
                np.asarray(out.step.visual_changes[i]), np.asarray(o.visual_changes)
            ), f"stream {i} changes"
            truth = {(f, r) for f in range(8) for r in range(8) if occ[f, r]}
            assert occupancy_to_set(np.asarray(out.step.occupancy[i])) == truth

    def test_33_streams_cross_the_flat_scan_threshold(self, rng):
        """The single-chip batched tick nests its stream scan (nested_scan)
        so no FLAT lax.scan reaches length >= 32. 33 streams (2 groups of
        16 + remainder 1) must step and match ground truth."""
        g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
        n = 33
        ms = MultiStreamPipeline(g, n_streams=n)
        state = ms.init_state()
        occs = []
        frames0 = []
        for i in range(n):
            occ = initial_occupancy()
            if i % 2:
                occ[4, 1] = False
                occ[4, 3] = True
            occs.append(occ)
            frames0.append(make_board_frame(occ, rng))
        state = ms.capture_reference(state, np.stack(frames0))
        frames1 = np.stack([make_board_frame(occ, rng) for occ in occs])
        state, out = ms.step(state, frames1)
        for i in range(n):
            truth = {(f, r) for f in range(8) for r in range(8) if occs[i][f, r]}
            assert occupancy_to_set(np.asarray(out.step.occupancy[i])) == truth, i

    def test_sharded_over_virtual_mesh(self, rng):
        """Same batched tick with the stream axis sharded over 8 CPU devices."""
        assert len(jax.devices()) == 8, "conftest should provide 8 virtual devices"
        mesh = make_mesh(8, ("data",))
        g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
        n = 8
        ms = MultiStreamPipeline(g, n_streams=n, mesh=mesh)
        state = ms.init_state()
        occ = initial_occupancy()
        frames = np.stack([make_board_frame(occ, rng) for _ in range(n)])
        state = ms.capture_reference(state, frames)
        state, out = ms.step(state, frames)
        occ_out = np.asarray(out.step.occupancy)
        truth = {(f, r) for f in range(8) for r in range(8) if occ[f, r]}
        for i in range(n):
            assert occupancy_to_set(occ_out[i]) == truth
        # the stream axis really is sharded
        shard_devs = {d for s in jax.tree.leaves(state.pipe)[0].addressable_shards for d in [s.device]}
        assert len(shard_devs) == 8

    def test_meshed_fold_bitexact_vs_meshless_scan(self, rng):
        """The two batched execution forms (stream-folded SPMD core on a
        mesh vs the single-chip scan over streams) produce bit-identical
        outputs and state on distinct per-stream positions — guards the
        fold's stream-major tiling of per-square constants."""
        mesh = make_mesh(8, ("data",))
        g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
        n = 8
        occs = []
        for i in range(n):
            occ = initial_occupancy()
            if i % 2:
                occ[4, 1] = False
                occ[4, 3] = True
            if i % 3 == 0:
                occ[0, 0] = False
            occs.append(occ)
        f0 = np.stack([make_board_frame(o, rng) for o in occs])
        f1 = np.stack([make_board_frame(o, rng) for o in occs])

        results = []
        for m in (mesh, None):
            ms = MultiStreamPipeline(g, n_streams=n, mesh=m)
            st = ms.capture_reference(ms.init_state(), f0)
            st, out = ms.step(st, f1)
            results.append((jax.tree.map(np.asarray, st),
                            jax.tree.map(np.asarray, out)))
        (st_m, out_m), (st_s, out_s) = results
        for a, b in zip(jax.tree.leaves(out_m), jax.tree.leaves(out_s)):
            assert np.array_equal(a, b)
        for a, b in zip(jax.tree.leaves(st_m), jax.tree.leaves(st_s)):
            assert np.array_equal(a, b)


class TestBatchedConfigSurface:
    """The full single-stream config surface in the N-stream shape:
    enhancer, tuned sensitivity, detector overrides."""

    def test_batched_enhancer_matches_single(self, rng):
        """Shared geometry, scan path: MultiStreamPipeline(with_enhancer)
        is bit-identical per stream to VisionPipeline(with_enhancer) —
        BASELINE config 1 semantics in the batched deployment shape."""
        from chessboard_vision.models.pipeline import VisionPipeline
        from chessboard_vision.ops import static_resample as sr

        profile = {"contrast": 1.1, "brightness": 6, "sat_scale": 1.2}
        g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
        occ_a = initial_occupancy()
        occ_b = initial_occupancy()
        occ_b[4, 1] = False
        occ_b[4, 3] = True
        f0 = [make_board_frame(occ_a, rng), make_board_frame(occ_b, rng)]
        f1 = [make_board_frame(occ_a, rng), make_board_frame(occ_b, rng)]
        p0 = np.stack([sr.to_planar(f) for f in f0])
        p1 = np.stack([sr.to_planar(f) for f in f1])

        ms = MultiStreamPipeline(
            g, n_streams=2, with_enhancer=True, enhancer_profile=profile,
        )
        state = ms.capture_reference(ms.init_state(), p0)
        state, out = ms.step(state, p1)

        for i, occ in enumerate((occ_a, occ_b)):
            pipe = VisionPipeline(
                g, with_enhancer=True, enhancer_profile=profile,
                donate_state=False,
            )
            st = pipe.capture_reference(pipe.init_state(), p0[i])
            st, o = pipe.step(st, p1[i])
            for field in o._fields:
                assert np.array_equal(
                    np.asarray(getattr(out.step, field)[i]),
                    np.asarray(getattr(o, field)),
                ), f"stream {i} field {field}"
            truth = {(f, r) for f in range(8) for r in range(8) if occ[f, r]}
            assert occupancy_to_set(np.asarray(out.step.occupancy[i])) == truth

    def test_batched_change_settings_and_overrides_match_single(self, rng):
        """Tuned sensitivity (change_settings incl. a non-default blur
        kernel) + calibrator detector_overrides are honored on the scan
        path, matching the single-stream pipeline bit-for-bit."""
        from chessboard_vision.models.pipeline import VisionPipeline
        from chessboard_vision.ops import static_resample as sr

        cs = {"z_threshold": 1.8, "alpha": 0.25, "initial_variance": 300.0,
              "blur_kernel": 7}
        ov = {"center_diff_threshold": 30.0, "hough_param2": 20}
        kw = dict(change_settings=cs, detector_overrides=ov)
        g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS, blur_pad=3)
        occ = initial_occupancy()
        f0 = [make_board_frame(occ, rng) for _ in range(2)]
        f1 = [make_board_frame(occ, rng) for _ in range(2)]
        p0 = np.stack([sr.to_planar(f) for f in f0])
        p1 = np.stack([sr.to_planar(f) for f in f1])

        ms = MultiStreamPipeline(g, n_streams=2, **kw)
        assert ms.pipe.z_threshold == 1.8 and ms.pipe.change_blur == 7
        assert ms.pipe._det_kwargs == {
            "center_diff_threshold": 30.0, "hough_param2": 20,
        }
        state = ms.capture_reference(ms.init_state(), p0)
        state, out = ms.step(state, p1)

        for i in range(2):
            pipe = VisionPipeline(g, donate_state=False, **kw)
            st = pipe.capture_reference(pipe.init_state(), p0[i])
            st, o = pipe.step(st, p1[i])
            for field in o._fields:
                assert np.array_equal(
                    np.asarray(getattr(out.step, field)[i]),
                    np.asarray(getattr(o, field)),
                ), f"stream {i} field {field}"

    def test_per_stream_geometry_enhanced_matches_singles(self, rng):
        """Per-stream calibrations + with_enhancer: each stream's color
        board rides its own tile plan; outputs equal independent
        VisionPipeline(with_enhancer=True) runs on each geometry."""
        from chessboard_vision.models.pipeline import VisionPipeline
        from chessboard_vision.ops import static_resample as sr

        profile = {"contrast": 1.05, "brightness": 3}
        corners_a = DEFAULT_CORNERS
        corners_b = DEFAULT_CORNERS + np.array([[12, 7], [-9, 5], [7, -6], [-10, -9]])
        geos = [
            geo.BoardGeometry.from_calibration(corners_a),
            geo.BoardGeometry.from_calibration(corners_b),
        ]
        occ_a = initial_occupancy()
        occ_b = initial_occupancy()
        occ_b[3, 1] = False
        occ_b[3, 3] = True
        f0 = [
            make_board_frame(occ_a, rng, corners=corners_a),
            make_board_frame(occ_b, rng, corners=corners_b),
        ]
        f1 = [
            make_board_frame(occ_a, rng, corners=corners_a),
            make_board_frame(occ_b, rng, corners=corners_b),
        ]
        p0 = np.stack([sr.to_planar(f) for f in f0])
        p1 = np.stack([sr.to_planar(f) for f in f1])

        ms = MultiStreamPipeline(
            geos, n_streams=2, with_enhancer=True, enhancer_profile=profile,
        )
        state = ms.capture_reference(ms.init_state(), p0)
        state, out = ms.step(state, p1)

        for i, (g, occ) in enumerate(zip(geos, (occ_a, occ_b))):
            pipe = VisionPipeline(
                g, with_enhancer=True, enhancer_profile=profile,
                donate_state=False,
            )
            st = pipe.capture_reference(pipe.init_state(), p0[i])
            st, o = pipe.step(st, p1[i])
            assert np.array_equal(
                np.asarray(out.step.occupancy[i]), np.asarray(o.occupancy)
            ), f"stream {i} occupancy"
            assert np.array_equal(
                np.asarray(out.step.visual_changes[i]),
                np.asarray(o.visual_changes),
            ), f"stream {i} changes"
            truth = {(f, r) for f in range(8) for r in range(8) if occ[f, r]}
            assert occupancy_to_set(np.asarray(out.step.occupancy[i])) == truth


class TestPerStreamChunkHWC:
    def test_step_chunk_accepts_hwc_in_per_stream_mode(self, rng):
        """step_chunk's documented (T, N, H, W, 3) HWC host input must be
        converted for the planar-only per-stream extraction (review fix);
        tick semantics must equal sequential step() calls."""
        from fixtures import make_board_frame

        corners_a = DEFAULT_CORNERS
        corners_b = DEFAULT_CORNERS + np.array([[10, 6], [-8, 4], [6, -5], [-9, -8]])
        geos = [
            geo.BoardGeometry.from_calibration(corners_a),
            geo.BoardGeometry.from_calibration(corners_b),
        ]
        occ = initial_occupancy()
        f0 = np.stack([
            make_board_frame(occ, rng, corners=corners_a),
            make_board_frame(occ, rng, corners=corners_b),
        ])
        ticks = np.stack([
            np.stack([
                make_board_frame(occ, rng, corners=corners_a),
                make_board_frame(occ, rng, corners=corners_b),
            ])
            for _ in range(3)
        ])  # (T=3, N=2, H, W, 3) HWC

        ms = MultiStreamPipeline(geos, n_streams=2)
        state0 = ms.capture_reference(ms.init_state(), f0)

        import jax
        st_chunk, out_chunk = ms.step_chunk(
            jax.tree.map(jnp.copy, state0), ticks
        )

        st_seq = jax.tree.map(jnp.copy, state0)
        for t in range(3):
            st_seq, out_t = ms.step(st_seq, ticks[t])
            assert np.array_equal(
                np.asarray(out_chunk.step.occupancy[t]),
                np.asarray(out_t.step.occupancy),
            ), f"tick {t}"


class TestStreamMajorChunk:
    """The shared-geometry single-chip step_chunk runs STREAM-MAJOR (outer
    scan over streams, tick scan inside with the small single-stream
    carry). The loop interchange must be invisible: outputs
    AND final state bit-equal to sequential per-tick step() calls."""

    def test_chunk_bitexact_vs_sequential_ticks(self, rng):
        from fixtures import make_board_frame

        g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
        n, t_len = 3, 4
        occs = []
        for i in range(n):
            occ = initial_occupancy()
            if i % 2:
                occ[4, 1] = False
                occ[4, 3] = True
            if i == 2:
                occ[0, 0] = False
            occs.append(occ)
        f0 = np.stack([make_board_frame(o, rng) for o in occs])
        ticks = np.stack([
            np.stack([make_board_frame(o, rng) for o in occs])
            for _ in range(t_len)
        ])  # (T, N, H, W, 3) HWC

        ms = MultiStreamPipeline(g, n_streams=n)
        state0 = ms.capture_reference(ms.init_state(), f0)

        st_chunk, out_chunk = ms.step_chunk(
            jax.tree.map(jnp.copy, state0), ticks
        )

        st_seq = jax.tree.map(jnp.copy, state0)
        for t in range(t_len):
            st_seq, out_t = ms.step(st_seq, ticks[t])
            for field in out_t.step._fields:
                assert np.array_equal(
                    np.asarray(getattr(out_chunk.step, field)[t]),
                    np.asarray(getattr(out_t.step, field)),
                ), f"tick {t} field {field}"
            for field in out_t.noise._fields:
                assert np.array_equal(
                    np.asarray(getattr(out_chunk.noise, field)[t]),
                    np.asarray(getattr(out_t.noise, field)),
                ), f"tick {t} noise field {field}"
        for a, b in zip(jax.tree.leaves(st_chunk), jax.tree.leaves(st_seq)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        # decisions also match ground truth
        for i, occ in enumerate(occs):
            truth = {(f, r) for f in range(8) for r in range(8) if occ[f, r]}
            assert occupancy_to_set(
                np.asarray(out_chunk.step.occupancy[-1, i])
            ) == truth, i

    def test_chunk_bitexact_with_enhancer(self, rng):
        """BASELINE config 1 on the stream-major chunk: with_enhancer
        ticks equal sequential enhanced step() calls."""
        from fixtures import make_board_frame
        from chessboard_vision.ops import static_resample as sr

        profile = {"contrast": 1.1, "brightness": 5}
        g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
        n, t_len = 2, 3
        occ = initial_occupancy()
        f0 = np.stack([
            sr.to_planar(make_board_frame(occ, rng)) for _ in range(n)
        ])
        ticks = np.stack([
            np.stack([
                sr.to_planar(make_board_frame(occ, rng)) for _ in range(n)
            ])
            for _ in range(t_len)
        ])  # (T, N, 3, H, W) planar

        ms = MultiStreamPipeline(
            g, n_streams=n, with_enhancer=True, enhancer_profile=profile,
        )
        state0 = ms.capture_reference(ms.init_state(), f0)
        st_chunk, out_chunk = ms.step_chunk(
            jax.tree.map(jnp.copy, state0), ticks
        )
        st_seq = jax.tree.map(jnp.copy, state0)
        for t in range(t_len):
            st_seq, out_t = ms.step(st_seq, ticks[t])
            for field in out_t.step._fields:
                assert np.array_equal(
                    np.asarray(getattr(out_chunk.step, field)[t]),
                    np.asarray(getattr(out_t.step, field)),
                ), f"tick {t} field {field}"
        for a, b in zip(jax.tree.leaves(st_chunk), jax.tree.leaves(st_seq)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
