"""Op-level device profile of one pipeline step: the PERF.md workflow as a CLI.

Builds the bench pipeline (synthetic 1080p board), runs N chained steps
under a jax.profiler trace, and prints the top GPU kernels with the source
line of their HLO op plus per-file totals. Needs the GPU; on a backend
without one the trace holds no GPU kernels and the tool says so instead of
printing an empty table.

Usage:
    python -m chessboard_vision.tools.profile_step [--enhance]
        [--steps N] [--top K] [--width W --height H]

The per-stage (bucketed) variant of this attribution ships in bench.py's
``per_stage_ms`` extras (utils/profiling.aggregate_device_op_ms); this
tool keeps the kernel granularity for kernel work.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

TRACE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "traces", "profile_step",
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--enhance", action="store_true",
                    help="profile the with_enhancer pipeline")
    ap.add_argument("--steps", type=int, default=10,
                    help="chained steps inside the trace")
    ap.add_argument("--top", type=int, default=25, help="kernels to print")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args(argv)

    import numpy as np
    import jax
    import jax.numpy as jnp

    from chessboard_vision import geometry as geo
    from chessboard_vision.models.pipeline import VisionPipeline
    from chessboard_vision.ops.static_resample import to_planar
    from chessboard_vision.utils.jax_cache import enable_compile_cache
    from chessboard_vision.utils.profiling import device_op_rows
    from chessboard_vision.utils.synth import bench_frame

    enable_compile_cache()
    h, w = args.height, args.width
    frame, (x0, y0, bs) = bench_frame(np.random.default_rng(0), h, w)
    corners = np.array([[x0, y0], [x0 + bs, y0], [x0, y0 + bs], [x0 + bs, y0 + bs]])
    pipe = VisionPipeline(
        geo.BoardGeometry.from_calibration(corners, display_size=(w, h)),
        with_enhancer=args.enhance,
    )
    fd = jnp.asarray(to_planar(frame))
    state = pipe.capture_reference(pipe.init_state(), fd)
    state, out = pipe.step(state, fd)
    jax.block_until_ready(out)
    hlo = pipe._step.lower(
        state, fd, pipe._zero_mask64, pipe._false, pipe._false, pipe._consts
    ).compile().as_text()

    jax.profiler.start_trace(TRACE_DIR)
    for _ in range(args.steps):
        state, out = pipe.step(state, fd)
    jax.block_until_ready(out)
    jax.profiler.stop_trace()

    try:
        rows = device_op_rows(TRACE_DIR, [hlo])
    except RuntimeError:
        print("the trace holds no GPU kernels — run on the GPU backend")
        return 1

    n = args.steps
    per_op = defaultdict(float)
    per_file = defaultdict(float)
    for row in rows:
        src = row.source.rsplit(":", 1)[0].split("/")[-1] or "?"
        per_op[(row.name, row.source[-48:] or "?")] += row.ms / n
        per_file[src] += row.ms / n

    total = sum(per_op.values())
    print(f"device total {total:.4f} ms/step over {n} chained steps "
          f"({'enhanced' if args.enhance else 'plain'}, {w}x{h})")
    print("\nper source file (ms/step):")
    for src, ms in sorted(per_file.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.4f}  {src}")
    print(f"\ntop {args.top} kernels (ms/step):")
    for (name, src), ms in sorted(per_op.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"  {ms:8.4f}  {name[:60]:<60} {src}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
