#!/usr/bin/env python3
"""Benchmark: single-stream 1080p frame->FEN throughput on one GPU.

Prints ONE JSON line on stdout:
  {"metric": "fps_1080p_frame_to_fen", "value": N, "unit": "fps",
   "vs_baseline": N/500, "device": {...}, "extras": {...}}
(the BASELINE north-star is >=500 fps). ``device`` names the platform,
device kind and count JAX reports plus the card's name and power limit
from nvidia-smi. ``extras`` carries the full BASELINE metric surface
machine-readably: distinct-frames fps (16 distinct frames per chunk, two
alternating chunk buffers), strict-sync p50 latency, batched N-stream
aggregate, and the enhanced-path fps (measured in the same run unless
--dry). Human-readable details go to stderr.

The throughput path is the chunked step (pipeline.step_many): K frames per
device dispatch via lax.scan, one small D2H per chunk. Per-frame semantics
are identical to K sequential step() calls (parity-tested); the chunk only
adds bounded readback latency, which the move-stability gate (20 frames)
dwarfs. Per-frame decision latency is reported separately (strict-sync
p50: one step plus its readback per frame).

A measuring run fails when JAX finds no GPU. --dry runs tiny shapes on the
CPU and says so in ``device``; its numbers are not device metrics.

Flags: --dry, --frames N, --chunk K (frames per dispatch, default 64,
scanned as nested 16-frame inner scans).
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build(display_size, corners, **kw):
    from chessboard_vision import geometry as geo
    from chessboard_vision.models.pipeline import VisionPipeline

    g = geo.BoardGeometry.from_calibration(corners, display_size=display_size)
    return VisionPipeline(g, **kw)


_STAGE_OF = {
    "ops/matmul_resample.py": "warp_extract",
    "ops/warp.py": "warp_extract",
    "ops/static_resample.py": "warp_extract",
    "ops/filters.py": "preprocess",
    # color conversions get their own bucket (they were inside
    # "preprocess" through round 3): the LAB fast path (polynomial
    # gamma + Newton cbrt, ops/color.py) needs its own trace line.
    "ops/color.py": "color",
    "ops/canny.py": "hough",
    "ops/hough_conv.py": "hough",
    "ops/hough.py": "hough",
    "ops/piece.py": "piece_cascade",
    "models/piece_detector.py": "piece_cascade",
    "ops/change.py": "change_model",
    "ops/fsm.py": "fsm",
    "models/enhancer.py": "enhance",
    "ops/enhance.py": "enhance",
    "ops/pallas/bilateral.py": "enhance",
}


TRACE_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "traces")


def step_hlo_text(pipe, state, frame) -> str:
    """Compiled HLO of the pipeline's per-frame step program."""
    return pipe._step.lower(
        state, frame, pipe._zero_mask64, pipe._false, pipe._false, pipe._consts
    ).compile().as_text()


def step_many_hlo_text(pipe, state, frames, inner: int) -> str:
    """Compiled HLO of the pipeline's chunk program."""
    import jax.numpy as jnp

    k = frames.shape[0]
    return pipe._step_many.lower(
        state, frames, jnp.zeros((k, 64), bool), jnp.zeros((k,), bool),
        jnp.zeros((k,), bool), pipe._consts, inner_chunk=inner,
    ).compile().as_text()


def _per_stage_ms(trace_dir: str, iters: int, hlo_text: str) -> dict:
    """Per-pipeline-stage GPU ms from a jax.profiler trace (the generic
    aggregation lives in utils/profiling.aggregate_device_op_ms; ops whose
    innermost source line is the pipeline module itself are excluded)."""
    from chessboard_vision.utils.profiling import aggregate_device_op_ms

    return aggregate_device_op_ms(
        trace_dir, [hlo_text], stage_of=_STAGE_OF, per=iters,
        exclude_sources=("models/pipeline.py",),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dry", action="store_true", help="tiny CPU-friendly run")
    ap.add_argument(
        "--enhance", action="store_true",
        help="measure the with_enhancer pipeline (BASELINE config-1: the "
        "5-stage enhancement fused ahead of detection) and report it as "
        "the headline metric",
    )
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--passes", type=int, default=3,
                    help="measurement passes; the fastest is reported "
                    "(the per-pass median goes into extras)")
    ap.add_argument("--chunk", type=int, default=64, help="frames per device dispatch (nested 16-scans past 16)")
    ap.add_argument("--streams", type=int, default=8, help="batched-stream secondary bench")
    ap.add_argument("--trace", default=None, help="capture a jax.profiler trace to this dir")
    args = ap.parse_args()

    import jax

    if args.dry:
        jax.config.update("jax_platforms", "cpu")
    from chessboard_vision.utils.jax_cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from chessboard_vision.rules import occupancy_to_fen
    from chessboard_vision.utils.profiling import card_name_and_limit
    from chessboard_vision.utils.synth import bench_frame

    devices = jax.devices()
    if not args.dry and devices[0].platform != "gpu":
        log(f"FATAL: no GPU found (JAX devices: {devices}); a measuring run "
            "needs the card. Use --dry for a CPU sanity run.")
        sys.exit(3)
    device = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "card": "" if args.dry else card_name_and_limit(),
    }
    log(f"device: {device}")
    os.makedirs(TRACE_ROOT, exist_ok=True)

    rng = np.random.default_rng(0)
    if args.dry:
        h, w, iters = 360, 640, 16
        args.chunk = min(args.chunk, 4)
    else:
        h, w, iters = 1080, 1920, args.frames

    frame, (x0, y0, bs) = bench_frame(rng, h, w)
    corners = np.array([[x0, y0], [x0 + bs, y0], [x0, y0 + bs], [x0 + bs, y0 + bs]])
    pipe = build((w, h), corners, with_enhancer=args.enhance)
    state = pipe.init_state()

    from chessboard_vision.ops.static_resample import to_planar

    frame_dev = jnp.asarray(to_planar(frame))  # planar: the banded-matmul warp
    state = pipe.capture_reference(state, frame_dev)

    # warmup/compile
    t0 = time.time()
    state, out = pipe.step(state, frame_dev)
    jax.block_until_ready(out)
    log(f"compile+first step: {time.time() - t0:.1f}s")

    # steady state: frame -> occupancy -> FEN (host). Chunked dispatch
    # (K frames per lax.scan call, one (K, 64) D2H per chunk) with a
    # depth-2 chunk readback pipeline: every frame's occupancy is
    # transferred and turned into FEN on the host, while the D2H completion
    # overlaps later chunks. Bounded (2K+K)-frame latency — the move
    # stability gate needs 20 stable frames anyway, so decision latency is
    # governed by the strict-sync path reported below.
    K = max(1, args.chunk)
    n_chunks = max(1, iters // K)
    iters = n_chunks * K
    DEPTH = 2
    # Chunks of 32+ frames run as nested scans of 16 (step_many's
    # default); the K-fold D2H amortization is the same either way.
    INNER = 16 if K >= 32 else 0
    extras = {"chunk": K, "frames": iters}

    def measure_chunked(p, st, chunk_buffers, n_ch, passes, label):
        """Depth-2 pipelined chunk loop; every frame's occupancy becomes a
        FEN on the host. Returns (state, best ms/frame, last fen)."""
        st, outs = p.step_many(st, chunk_buffers[0], inner_chunk=INNER)
        jax.block_until_ready(outs)  # compile chunk program
        fen = [None]
        n_fens = [0]

        def drain(occ_dev):
            for occ in np.asarray(occ_dev):  # (K, 64)
                mask = occ.reshape(8, 8).T  # [rank*8+file] -> [file, rank]
                fen[0] = occupancy_to_fen(mask)
                n_fens[0] += 1

        # Best of N passes; the per-pass median is reported alongside in
        # ``extras`` so the artifact carries the conservative estimator
        # too.
        samples = []
        total = n_ch * chunk_buffers[0].shape[0]
        for _pass in range(passes):
            n_fens[0] = 0
            inflight = []
            t_start = time.perf_counter()
            for i in range(n_ch):
                st, outs = p.step_many(
                    st, chunk_buffers[i % len(chunk_buffers)], inner_chunk=INNER
                )
                outs.occupancy.copy_to_host_async()
                inflight.append(outs.occupancy)
                if len(inflight) > DEPTH:
                    drain(inflight.pop(0))
            for occ_dev in inflight:
                drain(occ_dev)
            wall = time.perf_counter() - t_start
            assert n_fens[0] == total
            samples.append(wall / total)
            log(f"  {label} pass {_pass + 1}/{passes}: "
                f"{wall / total * 1e3:.2f} ms/frame")
        extras.setdefault("pass_median_fps", {})[label] = round(
            1.0 / float(np.median(samples)), 1
        )
        return st, min(samples), fen[0]

    same_chunk = jnp.asarray(
        np.broadcast_to(np.asarray(frame_dev), (K,) + frame_dev.shape).copy()
    )
    state, per_frame, fen = measure_chunked(
        pipe, state, [same_chunk], n_chunks, args.passes, "same-frame"
    )
    fps = 1.0 / per_frame
    variant = "enhanced " if args.enhance else ""
    log(f"single-stream {variant}(chunk {K}, depth {DEPTH}): "
        f"{per_frame * 1e3:.2f} ms/frame  fps {fps:.1f}  fen={fen.split()[0]}")

    # Distinct-frames variant: 2*K genuinely different frames (per-frame
    # sensor noise re-rendered on host, shipped once, device-resident),
    # alternating between two chunk buffers — no two consecutive chunk
    # inputs are equal and every frame inside a chunk differs.
    def noisy_chunk(seed):
        r = np.random.default_rng(seed)
        arr = np.stack([
            to_planar(
                np.clip(
                    frame.astype(np.int16) + r.integers(-4, 5, frame.shape),
                    0, 255,
                ).astype(np.uint8)
            )
            for _ in range(K)
        ])
        return jnp.asarray(arr)

    distinct = [noisy_chunk(1), noisy_chunk(2)]
    state, dist_ms, dist_fen = measure_chunked(
        pipe, state, distinct, n_chunks, max(1, args.passes - 1), "distinct"
    )
    log(f"distinct-frames: {dist_ms * 1e3:.2f} ms/frame  fps {1 / dist_ms:.1f}  "
        f"fen={dist_fen.split()[0]}")
    extras["distinct_frames_fps"] = round(1.0 / dist_ms, 1)

    # Per-stage device time (BASELINE secondary metric): a short
    # jax.profiler trace of chained steps, GPU kernel durations aggregated
    # by the source module of their HLO ops into pipeline stages. --dry
    # skips the aggregation (CPU traces carry no GPU kernels) but honors an
    # explicit --trace dir.
    n_tr = 5
    tdir = args.trace or os.path.join(TRACE_ROOT, "step")
    jax.profiler.start_trace(tdir)
    for _ in range(n_tr):
        state, out = pipe.step(state, frame_dev)
    jax.block_until_ready(out)
    jax.profiler.stop_trace()
    if not args.dry:
        stages = _per_stage_ms(tdir, n_tr, step_hlo_text(pipe, state, frame_dev))
        extras["per_stage_ms"] = stages
        log("per-stage device ms (traced, mean of 5 chained steps): "
            + ", ".join(f"{k}={v}" for k, v in stages.items()))
    log(f"trace written to {tdir}")

    # strict per-frame sync latency (one step plus its readback)
    times = []
    for i in range(min(20, iters)):
        t0 = time.perf_counter()
        state, out = pipe.step(state, frame_dev)
        _ = np.asarray(out.occupancy)
        times.append(time.perf_counter() - t0)
    strict_p50 = float(np.percentile(times, 50) * 1e3)
    log(f"strict-sync latency: p50 {strict_p50:.2f} ms")
    extras["strict_sync_p50_ms"] = round(strict_p50, 2)

    # secondary: batched streams on one chip
    def bench_batched(n, T, n_chunks_b, label, with_enh=False, distinct=False):
        """Aggregate fps for an n-stream batched pipeline driving
        (T, n, 3, H, W) tick chunks. distinct=True alternates two buffers
        of per-tick, per-stream noisy frames — no two inputs anywhere in
        the loop are equal (the same variant the single-stream bench
        runs)."""
        from chessboard_vision.parallel import MultiStreamPipeline
        from chessboard_vision import geometry as geo

        ms = MultiStreamPipeline(
            geo.BoardGeometry.from_calibration(corners, display_size=(w, h)),
            n_streams=n, with_enhancer=with_enh,
        )
        mstate = ms.init_state()
        frames0 = jnp.asarray(
            np.broadcast_to(to_planar(frame), (n, 3, h, w)).copy()
        )
        mstate = ms.capture_reference(mstate, frames0)
        if distinct:
            def noisy_tickbuf(seed):
                r = np.random.default_rng(seed)
                out = np.empty((T, n, 3, h, w), np.uint8)
                for t in range(T):
                    for i in range(n):
                        out[t, i] = to_planar(np.clip(
                            frame.astype(np.int16)
                            + r.integers(-4, 5, frame.shape),
                            0, 255,
                        ).astype(np.uint8))
                return jnp.asarray(out)

            buffers = [noisy_tickbuf(11), noisy_tickbuf(12)]
        else:
            buffers = [jnp.asarray(
                np.broadcast_to(np.asarray(frames0), (T,) + frames0.shape).copy()
            )]
        mstate, mouts = ms.step_chunk(mstate, buffers[0])
        jax.block_until_ready(mouts)  # compile the chunk program
        samples = []
        for _pass in range(max(1, args.passes - 1)):
            minfl = []
            t0 = time.perf_counter()
            for ci in range(n_chunks_b):
                mstate, mouts = ms.step_chunk(
                    mstate, buffers[ci % len(buffers)]
                )
                mouts.step.occupancy.copy_to_host_async()
                minfl.append(mouts.step.occupancy)
                if len(minfl) > 2:
                    np.asarray(minfl.pop(0))
            for o in minfl:
                np.asarray(o)
            samples.append((time.perf_counter() - t0) / (n_chunks_b * T))
            log(f"  batched {label} pass {_pass + 1}: "
                f"{samples[-1] * 1e3:.2f} ms/tick "
                f"({n / samples[-1]:.1f} fps aggregate)")
        mdt = min(samples)
        log(f"batched {label}: {mdt * 1e3:.2f} ms/tick -> "
            f"{n / mdt:.1f} frames/s aggregate")
        return round(n / mdt, 1)

    n = args.streams
    T = max(2, K)
    extras["batched_streams"] = n
    extras["batched_aggregate_fps"] = bench_batched(
        n, T, max(4, iters // (T * 4)), f"{n}-stream (chunk {T})"
    )
    # Every tick of every stream a DISTINCT frame (the broadcast variant
    # above leaves the same-input objection open). Shorter chunks bound the
    # device-resident buffer (2 x T x n frames).
    td = 8
    extras["batched_distinct_fps"] = bench_batched(
        n, td, 8, f"{n}-stream distinct (chunk {td})", distinct=True
    )
    # Scaling datapoint: 2N streams. Chunk sized to bound the buffer.
    n2 = 2 * n
    t2 = max(2, min(K, 256 // n2))
    extras[f"batched_{n2}stream_fps"] = bench_batched(
        n2, t2, 4, f"{n2}-stream (chunk {t2})"
    )

    # Enhanced path (BASELINE config 1) in the same run, so the artifact
    # carries the full metric surface. Skipped under --enhance (it IS the
    # headline then) and under --dry (compile cost).
    if not args.enhance and not args.dry:
        epipe = build((w, h), corners, with_enhancer=True)
        estate = epipe.init_state()
        estate = epipe.capture_reference(estate, frame_dev)
        en_chunks = max(1, min(n_chunks, 512 // K))
        estate, ems, efen = measure_chunked(
            epipe, estate, [same_chunk], en_chunks, args.passes, "enhanced"
        )
        log(f"enhanced: {ems * 1e3:.2f} ms/frame  fps {1 / ems:.1f}  "
            f"fen={efen.split()[0]}")
        extras["enhanced_fps"] = round(1.0 / ems, 1)
        extras["enhanced_vs_baseline"] = round(1.0 / ems / 500.0, 3)
        # Trace the already-compiled chunk program (one call = K chained
        # steps) instead of compiling the per-frame enhanced step for it.
        etdir = os.path.join(TRACE_ROOT, "enhanced")
        jax.profiler.start_trace(etdir)
        estate, eouts = epipe.step_many(estate, same_chunk, inner_chunk=INNER)
        jax.block_until_ready(eouts)
        jax.profiler.stop_trace()
        estages = _per_stage_ms(
            etdir, K, step_many_hlo_text(epipe, estate, same_chunk, INNER)
        )
        extras["per_stage_ms_enhanced"] = estages
        log("enhanced per-stage device ms: "
            + ", ".join(f"{k}={v}" for k, v in estages.items()))
        # Batched-enhanced datapoints (BASELINE config 1 in the N-stream
        # deployment shape), same frames and distinct frames.
        tbe = 8
        extras["batched_enhanced_fps"] = bench_batched(
            args.streams, tbe, 16,
            f"{args.streams}-stream enhanced (chunk {tbe})",
            with_enh=True,
        )
        extras["batched_enhanced_distinct_fps"] = bench_batched(
            args.streams, tbe, 16,
            f"{args.streams}-stream enhanced distinct (chunk {tbe})",
            with_enh=True, distinct=True,
        )

    metric = "fps_1080p_enhanced_frame_to_fen" if args.enhance else "fps_1080p_frame_to_fen"
    print(json.dumps({
        "metric": metric,
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(fps / 500.0, 3),
        "device": device,
        "extras": extras,
    }))


if __name__ == "__main__":
    main()
