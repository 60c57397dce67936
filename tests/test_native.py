"""Native C++ runtime tests: resampler parity vs the JAX path, ring buffer
semantics (SPSC, drop-oldest, skip-to-latest) incl. a threaded producer."""

import threading

import numpy as np
import pytest

from chessboard_vision import native
from chessboard_vision import geometry as geo

pytestmark = pytest.mark.skipif(not native.AVAILABLE, reason="native lib unavailable")

CORNERS = np.array([[173, 133], [1100, 110], [150, 650], [1131, 680]])


class TestHostResampler:
    def test_gray_matches_device_path(self, rng):
        import jax.numpy as jnp
        from chessboard_vision.ops import static_resample as sr

        frame = rng.integers(0, 256, (720, 1280, 3), np.uint8)
        g = geo.BoardGeometry.from_calibration(CORNERS)
        qx, qy = g.square_query_coords()
        host = native.HostResampler(qx, qy, g.src_h, g.src_w)

        plan = sr.ResamplePlan.build(qx, qy, g.src_h, g.src_w)
        b, gg, r = sr.resample_bgr(jnp.asarray(sr.to_planar(frame)), plan, g.src_w)
        x = np.stack([np.asarray(b), np.asarray(gg), np.asarray(r)]).astype(np.int64)
        dev_gray = ((x[2] * 9798 + x[1] * 19235 + x[0] * 3735 + (1 << 14)) >> 15).astype(np.uint8)

        host_gray = host.resample_gray(frame)
        assert np.array_equal(host_gray, dev_gray)

    def test_bgr_matches_device_path(self, rng):
        import jax.numpy as jnp
        from chessboard_vision.ops import static_resample as sr

        frame = rng.integers(0, 256, (720, 1280, 3), np.uint8)
        g = geo.BoardGeometry.from_calibration(CORNERS)
        qx, qy = g.square_query_coords()
        host = native.HostResampler(qx, qy, g.src_h, g.src_w)
        plan = sr.ResamplePlan.build(qx, qy, g.src_h, g.src_w)
        db, dg, dr = sr.resample_bgr(jnp.asarray(sr.to_planar(frame)), plan, g.src_w)
        hb, hg, hr = host.resample_bgr(frame)
        assert np.array_equal(hb, np.asarray(db))
        assert np.array_equal(hg, np.asarray(dg))
        assert np.array_equal(hr, np.asarray(dr))

    def test_to_planar(self, rng):
        frame = rng.integers(0, 256, (64, 48, 3), np.uint8)
        out = native.to_planar_native(frame)
        assert np.array_equal(out, np.moveaxis(frame, -1, 0))


class TestFrameRing:
    def test_push_pop_fifo(self):
        ring = native.FrameRing((4, 4), n_slots=4)
        frames = [np.full((4, 4), i, np.uint8) for i in range(3)]
        for f in frames:
            ring.push(f)
        assert len(ring) == 3
        for i in range(3):
            seq, out = ring.pop()
            assert seq == i + 1
            assert np.array_equal(out, frames[i])
        seq, out = ring.pop()
        assert seq == 0 and out is None
        ring.close()

    def test_drop_oldest_when_full(self):
        ring = native.FrameRing((2, 2), n_slots=2)
        for i in range(5):
            ring.push(np.full((2, 2), i, np.uint8))
        assert len(ring) == 2
        seq, out = ring.pop()
        assert out[0, 0] == 3  # oldest surviving
        assert seq == 4
        assert ring.dropped == 3  # consumer-side lap accounting
        seq, out = ring.pop()
        assert out[0, 0] == 4 and seq == 5
        assert ring.pop() == (0, None)
        ring.close()

    def test_skip_to_latest(self):
        ring = native.FrameRing((2, 2), n_slots=8)
        for i in range(5):
            ring.push(np.full((2, 2), i, np.uint8))
        skipped = ring.skip_to_latest()
        assert skipped == 4
        seq, out = ring.pop()
        assert out[0, 0] == 4
        ring.close()

    def test_threaded_producer_consumer(self):
        ring = native.FrameRing((8, 8), n_slots=16)
        n = 200
        got = []

        def producer():
            for i in range(n):
                ring.push(np.full((8, 8), i % 251, np.uint8))

        t = threading.Thread(target=producer)
        t.start()
        while t.is_alive() or len(ring):
            seq, out = ring.pop()
            if seq:
                got.append(seq)
        t.join()
        # sequences strictly increasing, no duplicates
        assert all(b > a for a, b in zip(got, got[1:]))
        assert len(got) + ring.dropped == n
        ring.close()
