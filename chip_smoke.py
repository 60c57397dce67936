#!/usr/bin/env python3
"""Smoke run of the frame->FEN system on one NVIDIA GPU.

Drives the main path through the entry points a user calls and checks
every result against the repo's own references:

  0. device: the first JAX device must be a GPU;
  1. the reference rig (1280x720 camera, HWC frames) through GameSession:
     a scripted game with a capture and a castle, plain and enhanced;
  2. the 1080p single stream (planar frames, plain and enhanced): step_many
     bit-equal to sequential steps on the card, and the same program on the
     host CPU equal in decisions on every frame; the HWC gather warp too;
  3. both Hough backends on the phase-2 frames: agreement and ms/frame;
  4. kernel parity at real widths (bilateral, CLAHE, Hough score product);
  5. MultiStreamPipeline, 8 streams at 1080p on one card, each stream
     bit-equal to an independent VisionPipeline;
  6. the checks behind the ``gpu``-marked tests (tests/card_checks.py).

``--multi`` runs only the mesh path on four cards: 8 streams at 1080p,
plain and enhanced, over a 4-way data mesh and a 2x2 data x space mesh,
each stream bit-equal to the single-device result.

Every line with a number names the card. The last line of stdout is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}. Any
failed check exits nonzero before that line is printed.

Usage: python chip_smoke.py [--multi]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "tests"))

SESSION_CORNERS = [[260, 80], [1020, 95], [240, 640], [1035, 655]]
SCRIPT = "e2e4 d7d5 e4d5 g8f6 g1f3 e7e6 f1e2 f8e7 e1g1"
FIELDS = ("occupancy", "visual_changes", "radius")


CARD = ""


def say(*parts) -> None:
    print(f"[{CARD}]", *parts, flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def bench_geometry():
    """bench.py's 1080p rig: an axis-aligned board of side min(h, w) - 100."""
    from chessboard_vision import geometry as geo
    from chessboard_vision.utils.synth import bench_frame

    frame, (x0, y0, bs) = bench_frame(np.random.default_rng(0), 1080, 1920)
    corners = np.array([[x0, y0], [x0 + bs, y0], [x0, y0 + bs], [x0 + bs, y0 + bs]])
    return geo.BoardGeometry.from_calibration(corners, display_size=(1920, 1080)), frame


def noisy_frames(frame, n: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    return np.stack([
        np.clip(frame.astype(np.int16) + r.integers(-4, 5, frame.shape), 0, 255).astype(np.uint8)
        for _ in range(n)
    ])


def planar(frames_hwc: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(frames_hwc, -1, -3))


# -- phase 1 ----------------------------------------------------------------


def phase_session(use_enhancer: bool) -> None:
    from chessboard_vision.rules import chess
    from chessboard_vision.session.game_session import GameSession
    from chessboard_vision.utils.synth import add_noise, perspective_frame

    def occupancy(board):
        occ = np.zeros((8, 8), bool)
        for sq in chess.SQUARES:
            if board.piece_at(sq) is not None:
                occ[chess.square_file(sq), chess.square_rank(sq)] = True
        return occ

    rng = np.random.default_rng(7)
    session = GameSession(headless=True)
    session.MOVE_COOLDOWN = 0.0
    config = {
        "corners": SESSION_CORNERS, "player_color": "white",
        "orientation_flipped": False, "grid_lines_x": None, "grid_lines_y": None,
        "use_enhancer": use_enhancer,
    }
    require(session.on_calibration_requested(None, config=config), "calibration")
    script = chess.Board()
    session.capture_reference_frame(perspective_frame(occupancy(script), SESSION_CORNERS, rng))
    n_frames, t0, step_s = 0, time.perf_counter(), 0.0
    for uci in SCRIPT.split():
        script.push_uci(uci)
        # One render per position; every frame adds its own sensor noise.
        base = perspective_frame(occupancy(script), SESSION_CORNERS, rng, frame_noise=0)
        got = None
        for _ in range(60):
            frame = add_noise(base, rng, 2.0)
            ts = time.perf_counter()
            got = session.on_frame(frame)
            step_s += time.perf_counter() - ts
            n_frames += 1
            if got:
                break
        require(got is not None and got.uci() == uci,
                f"session ({'enhanced' if use_enhancer else 'plain'}) committed "
                f"{got.uci() if got else None} for scripted {uci}")
    require(session.game.get_fen() == script.fen(),
            f"final FEN {session.game.get_fen()} != {script.fen()}")
    say(f"phase 1 GameSession {'enhanced' if use_enhancer else 'plain'}: "
        f"{len(SCRIPT.split())} moves committed, final FEN equal "
        f"({session.game.get_fen()}); {n_frames} frames, on_frame mean "
        f"{step_s / n_frames * 1e3:.3f} ms incl. compile, wall {time.perf_counter() - t0:.1f} s")


# -- phase 2 / 3 -------------------------------------------------------------


def run_chunk(pipe, frames_dev):
    """capture_reference(frame 0), then one step_many over the chunk;
    returns (outputs, compile+first seconds, warm ms/frame)."""
    import jax

    st = pipe.capture_reference(pipe.init_state(), frames_dev[0])
    t0 = time.perf_counter()
    st, out = pipe.step_many(st, frames_dev)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0
    st2 = pipe.capture_reference(pipe.init_state(), frames_dev[0])
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        st2, out2 = pipe.step_many(st2, frames_dev)
    jax.block_until_ready(out2)
    ms = (time.perf_counter() - t0) / (reps * frames_dev.shape[0]) * 1e3
    return out, compile_s, ms


def phase_single_stream(geometry, frame, enhanced: bool, hough: str):
    import jax
    import jax.numpy as jnp
    from chessboard_vision.models.pipeline import VisionPipeline

    label = "enhanced" if enhanced else "plain"
    chunk = planar(noisy_frames(frame, 64, seed=1))
    frames_dev = jnp.asarray(chunk)
    pipe = VisionPipeline(geometry, with_enhancer=enhanced, hough_backend=hough)
    out, compile_s, ms = run_chunk(pipe, frames_dev)

    st = pipe.capture_reference(pipe.init_state(), frames_dev[0])
    seq = []
    for i in range(frames_dev.shape[0]):
        st, o = pipe.step(st, frames_dev[i])
        seq.append(o)
    for f in FIELDS:
        a = np.asarray(getattr(out, f))
        b = np.stack([np.asarray(getattr(o, f)) for o in seq])
        require(np.array_equal(a, b), f"{label}: step_many != sequential step on {f}")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    say(f"phase 2 {label} 1080p hough={hough}: step_many(64) bit-equal to 64 steps; "
        f"compile+first {compile_s:.2f} s; warm {ms:.4f} ms/frame (host clock, "
        f"block_until_ready); peak_bytes_in_use {peak}")

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        cpipe = VisionPipeline(geometry, with_enhancer=enhanced, hough_backend=hough)
        cframes = jnp.asarray(chunk)
        cst = cpipe.capture_reference(cpipe.init_state(), cframes[0])
        cst, cout = cpipe.step_many(cst, cframes)
        cgray = np.asarray(cpipe._preprocess_j(cframes[-1], cpipe._consts)[0]).astype(int)
    for f in ("occupancy", "visual_changes"):
        require(np.array_equal(np.asarray(getattr(out, f)), np.asarray(getattr(cout, f))),
                f"{label}: card != CPU on {f}")
    gray = np.asarray(pipe._preprocess_j(frames_dev[-1], pipe._consts)[0]).astype(int)
    d = np.abs(gray - cgray)
    say(f"phase 2 {label}: card decisions == CPU decisions on all 64 frames "
        f"(occupancy, visual_changes); gray squares max diff {d.max()} level(s), "
        f"{(d > 0).mean():.3e} of pixels differ")
    require(d.max() <= 1, f"{label}: gray squares differ by {d.max()} > 1 level")
    return chunk, out, ms


def phase_hwc_warp(geometry, frame) -> None:
    """The HWC gather warp (device HWC frames): card vs CPU decisions."""
    import jax
    import jax.numpy as jnp
    from chessboard_vision.models.pipeline import VisionPipeline

    frames = noisy_frames(frame, 8, seed=3)
    outs = []
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        with jax.default_device(dev):
            pipe = VisionPipeline(geometry)
            fr = jnp.asarray(frames)
            st = pipe.capture_reference(pipe.init_state(), fr[0])
            got = []
            for i in range(fr.shape[0]):
                st, o = pipe.step(st, fr[i])
                got.append(np.asarray(o.occupancy))
            outs.append(np.stack(got))
    require(np.array_equal(outs[0], outs[1]), "HWC gather warp: card != CPU occupancy")
    say(f"phase 2 HWC gather warp 1080p: card occupancy == CPU on {len(frames)} frames")


def phase_hough(geometry, frame) -> None:
    import jax.numpy as jnp
    from chessboard_vision.models.pipeline import VisionPipeline
    from chessboard_vision.platform import default_hough_backend

    frames_dev = jnp.asarray(planar(noisy_frames(frame, 64, seed=1)))
    res = {}
    for backend in ("exact", "conv"):
        out, compile_s, ms = run_chunk(VisionPipeline(geometry, hough_backend=backend), frames_dev)
        res[backend] = (np.asarray(out.occupancy), ms)
        say(f"phase 3 hough={backend} 1080p plain: {ms:.4f} ms/frame, compile+first {compile_s:.2f} s")
    agree = float((res["exact"][0] == res["conv"][0]).mean())
    auto = default_hough_backend()
    say(f"phase 3 exact-vs-conv decision agreement {agree * 100:.4f}% over "
        f"{res['exact'][0].size} square-frames; auto on this platform = {auto}")
    if auto == "conv":
        require(agree == 1.0, "auto is conv but conv disagrees with exact")


# -- phase 4 / 6 -------------------------------------------------------------


def phase_kernels(geometry) -> None:
    import card_checks as cc
    from chessboard_vision.ops import hough_conv as hc

    r = cc.check_bilateral((3, 980, 980))
    say(f"phase 4 bilateral (3, 980, 980) Triton kernel vs the XLA form on the card, "
        f"f32: max diff {r['max_diff']} level, {r['frac_diff']:.3e} of values "
        "(tolerance <= 1 level on < 1e-4)")
    r = cc.check_clahe((980, 980))
    say(f"phase 4 CLAHE 980x980 (984^2 padded): histograms == np.bincount; vs CPU "
        f"f32: max diff {r['max_diff']} level on {r['n_diff']} pixels, "
        f"{r['n_diff_off_tie']} of them away from a .5 tie (tolerance: only at ties, <= 1 level)")
    s = geometry.squares
    plan, _ = hc.ConvHoughPlan.build(s.heights, s.widths, plane_h=int(s.heights.max()),
                                      plane_w=int(s.widths.max()))
    mq, k = plan.basis.shape
    planes = np.random.default_rng(0).standard_normal((8, 64, k)).astype(np.float32)
    r1 = cc.check_score_matmul(plan.basis, planes[0])
    r8 = cc.check_score_matmul(plan.basis, planes, n_streams=8)
    say(f"phase 4 Hough score ({mq}, {k}) bf16 x ({k}, 64) bf16 -> f32 vs numpy f32: "
        f"err/bound {r1['err_over_bound']:.3e}; vmap 8 streams {r8['err_over_bound']:.3e} "
        "(bound K*eps_f32*sum|terms|)")


def phase_card_tests() -> None:
    import test_card as tc

    for fn, args in tc.CARD_CHECKS:
        res = fn(*args)
        shapes = tuple(getattr(a, "shape", a) for a in args)
        say(f"phase 6 {fn.__name__}{shapes}: {res}")


# -- phase 5 / --multi ---------------------------------------------------------


def stream_frames(frame, n_streams: int, ticks: int) -> np.ndarray:
    """(T, N, 3, H, W) planar frames, distinct per tick and stream."""
    per = [noisy_frames(frame, ticks, seed=100 + s) for s in range(n_streams)]
    return planar(np.stack(per, axis=1))


def single_stream_reference(geometry, frames, device, **kw):
    """Each stream through its own VisionPipeline on ``device``."""
    import jax
    import jax.numpy as jnp
    from chessboard_vision.models.pipeline import VisionPipeline

    with jax.default_device(device):
        pipe = VisionPipeline(geometry, **kw)
        res = []
        for s in range(frames.shape[1]):
            fr = jnp.asarray(frames[:, s])
            st = pipe.capture_reference(pipe.init_state(), fr[0])
            st, out = pipe.step_many(st, fr[1:])
            res.append(out)
    return res


def check_streams(ms_out, refs, label: str) -> None:
    for s, ref in enumerate(refs):
        for f in FIELDS:
            a = np.asarray(getattr(ms_out.step, f))[:, s]
            require(np.array_equal(a, np.asarray(getattr(ref, f))),
                    f"{label}: stream {s} {f} differs from its single-stream run")


def run_multistream(geometry, frames, mesh=None, **kw):
    import jax
    import jax.numpy as jnp
    from chessboard_vision.parallel import MultiStreamPipeline

    ms = MultiStreamPipeline(geometry, n_streams=frames.shape[1], mesh=mesh, **kw)
    st = ms.capture_reference(ms.init_state(), jnp.asarray(frames[0]))
    t0 = time.perf_counter()
    st, out = ms.step_chunk(st, jnp.asarray(frames[1:]))
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def phase_multistream(geometry, frame) -> None:
    import jax

    frames = stream_frames(frame, 8, ticks=9)
    out, secs = run_multistream(geometry, frames)
    check_streams(out, single_stream_reference(geometry, frames, jax.devices()[0]), "8-stream")
    say(f"phase 5 MultiStreamPipeline 8 streams x 8 ticks 1080p: every stream bit-equal "
        f"to its own VisionPipeline (occupancy, visual_changes, radius); "
        f"compile+first chunk {secs:.2f} s")


def multi(geometry, frame) -> None:
    import jax
    from chessboard_vision.parallel import make_mesh

    require(len(jax.devices()) >= 4, f"--multi needs 4 GPUs, found {len(jax.devices())}")
    frames = stream_frames(frame, 8, ticks=5)
    for enhanced in (False, True):
        kw = {"with_enhancer": enhanced}
        refs = single_stream_reference(geometry, frames, jax.devices()[0], **kw)
        for axes, shape in ((("data",), None), (("data", "space"), (2, 2))):
            mesh = make_mesh(4, axes, shape)
            out, secs = run_multistream(geometry, frames, mesh=mesh, **kw)
            label = f"{'enhanced' if enhanced else 'plain'} mesh {dict(mesh.shape)}"
            check_streams(out, refs, label)
            say(f"--multi {label}: 8 streams x 4 ticks 1080p, every stream bit-equal to "
                f"the single-device run; compile+first chunk {secs:.2f} s")


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description="Smoke run of the frame->FEN system on the GPU")
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU mesh path and its single-device comparison")
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices}", file=sys.stderr)
        return 2
    from chessboard_vision.utils.jax_cache import enable_compile_cache
    from chessboard_vision.utils.profiling import card_name_and_limit

    CARD = card_name_and_limit()
    require(CARD, "nvidia-smi did not report the card")

    enable_compile_cache()
    say(f"phase 0 device: {devices[0].device_kind}, {len(devices)} visible, jax {jax.__version__}")
    geometry, frame = bench_geometry()
    count = 1

    def timed(fn, *a, **kw):
        t0 = time.perf_counter()
        fn(*a, **kw)
        say(f"({fn.__name__} took {time.perf_counter() - t0:.1f} s wall)")

    if args.multi:
        timed(multi, geometry, frame)
        count = 4
    else:
        from chessboard_vision.platform import default_hough_backend

        timed(phase_session, use_enhancer=False)
        timed(phase_session, use_enhancer=True)
        for enhanced in (False, True):
            timed(phase_single_stream, geometry, frame, enhanced, default_hough_backend())
        timed(phase_hwc_warp, geometry, frame)
        timed(phase_hough, geometry, frame)
        timed(phase_kernels, geometry)
        timed(phase_multistream, geometry, frame)
        timed(phase_card_tests)
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
