"""Batched N-stream pipeline with mesh sharding.

The BASELINE north-star's batched configuration: N camera streams
processed in one device dispatch per frame-tick, with the stream axis
sharded over the device mesh ("data") so streams scale across devices
with zero cross-stream communication. The per-stream noise FSM runs
on device (ops/fsm.py) so the whole tick — warp, detect, change-detect,
FSM — is one XLA call; hosts only see per-stream occupancy + FSM events.

Two execution forms, chosen by mesh:
- one device (mesh=None): lax.scan over streams — each iteration is the
  single-stream program, so its (64, H, W) intermediates stay the
  single-stream size; batching the stream axis in front (vmap or fold)
  makes every canny/resample intermediate N times larger.
- meshed: a stream-FOLDED core — state and per-square constants tiled to
  (N*64, ...) so the perception core is shape-identical to a single-
  stream step with more squares and shards over dp / dp x sp meshes
  without serializing (a scan would serialize the sharded stream axis).
Which form is faster on the GPU is an open question (ROADMAP).

Per-stream calibration: pass a LIST of N BoardGeometry objects (one per
rig) instead of one. The geometry-dependent square extraction then runs
per stream with that stream's static resample plan (static region slices
stay static — vmapping them would turn them into gathers),
and the geometry-independent perception/FSM core is vmapped across
streams. All rigs must share the same grid structure (square heights/
widths — true for linear grids at a common capture resolution); corner
positions/homographies are free per stream.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from chessboard_vision.geometry import BoardGeometry
from chessboard_vision.models.pipeline import (
    StepConsts, VisionPipeline, PipelineState, StepOutputs,
)
from chessboard_vision.ops import fsm as fsm_ops
from chessboard_vision.ops import piece as piece_ops
from chessboard_vision.parallel import mesh as mesh_lib


class MultiStreamState(NamedTuple):
    pipe: PipelineState  # leaves with leading (N,) stream axis
    noise: fsm_ops.NoiseFsmState  # leaves with leading (N,) stream axis


class MultiStreamOutputs(NamedTuple):
    step: StepOutputs  # leaves (N, ...)
    noise: fsm_ops.NoiseFsmOut  # leaves (N, ...)


class MultiStreamPipeline:
    """N-stream batched pipeline over one (optionally sharded) mesh."""

    def __init__(
        self,
        geometry,
        n_streams: int,
        mesh=None,
        piece_settings: Optional[dict] = None,
        with_change_detector: bool = True,
        change_settings: Optional[dict] = None,
        detector_overrides: Optional[dict] = None,
        with_enhancer: bool = False,
        enhancer_profile: Optional[dict] = None,
        hough_backend: str = "auto",
    ):
        """The batched pipeline takes the FULL single-stream config surface:
        tuned sensitivity (``change_settings``),
        calibrator threshold overrides (``detector_overrides``), and the
        fused 5-stage enhancement (``with_enhancer``/``enhancer_profile`` —
        BASELINE config 1) are honored in the N-stream deployment shape,
        not just single-stream sessions. In per-stream-geometry mode the
        enhancer's frame->board color warp runs with each stream's own
        tile plan; the board-space square extraction plan is shared (the
        grid structure is, by construction)."""
        self.n_streams = n_streams
        self.mesh = mesh
        if isinstance(geometry, (list, tuple)):
            geos = list(geometry)
            if len(geos) != n_streams:
                raise ValueError(
                    f"got {len(geos)} geometries for {n_streams} streams"
                )
            base = geos[0]
            for i, g in enumerate(geos[1:], 1):
                if not (
                    np.array_equal(g.squares.heights, base.squares.heights)
                    and np.array_equal(g.squares.widths, base.squares.widths)
                    and (g.src_h, g.src_w) == (base.src_h, base.src_w)
                ):
                    raise ValueError(
                        f"stream {i}: per-stream geometries must share the "
                        "grid structure (square heights/widths) and capture "
                        "resolution; only corners/homography may differ"
                    )
        else:
            base, geos = geometry, None
        self.pipe = VisionPipeline(
            base,
            piece_settings=piece_settings,
            with_change_detector=with_change_detector,
            change_settings=change_settings,
            detector_overrides=detector_overrides,
            with_enhancer=with_enhancer,
            enhancer_profile=enhancer_profile,
            hough_backend=hough_backend,
            donate_state=False,  # donation handled on the batched jit below
        )
        if geos is not None:
            from chessboard_vision.ops import matmul_resample as mr

            self._stream_plans = []
            for g in geos:
                if with_enhancer:
                    # Enhancer mode warps the COLOR board first, so each
                    # stream needs its frame->board TILE plan; the
                    # board-space square extraction plan (consts.
                    # enh_ext_plan) is shared across streams.
                    tqx, tqy, _starts, _t = g.board_tile_query_coords()
                    self._stream_plans.append(
                        mr.build_plan(tqx, tqy, g.src_h, g.src_w)
                    )
                else:
                    qx, qy = g.square_query_coords()
                    self._stream_plans.append(
                        mr.build_plan(qx, qy, g.src_h, g.src_w)
                    )
            # All plans produce (64, Qr, Qc) samples of the shared grid
            # structure; each carries its own static dims (band/region).
            # The multi-MB plan ARRAYS ride as jit arguments (the
            # StepConsts rule — closure literals multiply compile time and
            # bloat every derived program); only the static dims shape the
            # program from the closure.
            self._plan_arrays = tuple(p for p, _ in self._stream_plans)
            self._plan_dims = tuple(d for _, d in self._stream_plans)
        else:
            self._stream_plans = None
            self._plan_arrays = ()
            self._plan_dims = ()

        # Stream-folded perception core: the geometry-independent half of
        # the tick runs ONCE on (N*64, H, W) with per-square constants
        # tiled N-fold, instead of vmapping the 64-square program per
        # stream. The folded program is shape-identical to a single-stream
        # step with more squares, so it inherits that program's measured
        # layouts/fusions (the vmapped form put the stream axis in the
        # second-minor dimension and fused worse), and the Hough basis
        # matmul reads its ~45 MB operand once for all streams.
        # Bit-exact: every folded op is elementwise or a per-square
        # reduction. The FSM keeps the per-stream (N, 64) view.
        n64 = n_streams * 64
        # Only meshed runs use the folded core; the single-chip scan path
        # never reads these, so skip the ~30 MB of tiled device constants
        # (None is a valid empty-pytree jit argument).
        self._folded_consts = None if mesh is None else StepConsts(
            dg=self.pipe._consts.dg._replace(
                sq_mask=self._tile(self.pipe._consts.dg.sq_mask),
                sq_mask_flat=self._tile(self.pipe._consts.dg.sq_mask_flat),
                sq_counts=self._tile(self.pipe._consts.dg.sq_counts),
                sq_heights=self._tile(self.pipe._consts.dg.sq_heights),
                sq_widths=self._tile(self.pipe._consts.dg.sq_widths),
            ),
            masks=piece_ops.PieceMasks(
                *[self._tile(leaf) for leaf in self.pipe._consts.masks]
            ),
            params=type(self.pipe._consts.params)(
                *[self._tile(leaf) for leaf in self.pipe._consts.params]
            ),
            conv_plan=None if self.pipe._consts.conv_plan is None
            else self.pipe._consts.conv_plan._replace(
                r_valid=self._tile(self.pipe._consts.conv_plan.r_valid),
                r_min=self._tile(self.pipe._consts.conv_plan.r_min),
                r_max=self._tile(self.pipe._consts.conv_plan.r_max),
                win_offset_y=self._tile(self.pipe._consts.conv_plan.win_offset_y),
                win_offset_x=self._tile(self.pipe._consts.conv_plan.win_offset_x),
                win_mask=jnp.tile(
                    self.pipe._consts.conv_plan.win_mask, (1, 1, n_streams)
                ),
                # find_circle's masking runs on the pruned-row validity
                # table; its square axis is LAST (matmul-output order).
                kvalid=jnp.tile(
                    self.pipe._consts.conv_plan.kvalid, (1, n_streams)
                ),
            ),
            mm_plan=self.pipe._consts.mm_plan,
        )

        def fold(x):  # (N, 64, ...) -> (N*64, ...)
            return x.reshape((n64,) + x.shape[2:])

        def unfold(x):  # (N*64, ...) -> (N, 64, ...)
            return x.reshape((self.n_streams, 64) + x.shape[1:])

        # Single-device batched ticks run as a lax.scan over streams
        # instead: each iteration is the single-stream program, whose
        # (64, H, W) intermediates stay single-stream sized (the 8x-wider
        # folded/vmapped program materializes every canny/resample
        # intermediate N times larger). On a mesh the folded SPMD form is
        # used instead: a scan would serialize the sharded stream axis.
        def scan_streams(state, frames_or_gray, gray_cd, s2c_mask, s2c_given, refresh, consts, with_preprocess):
            has_cd = gray_cd is not None  # change detector's own-blur gray

            def body(_, xs):
                pipe_st, noise_st, fr, m, g, r = xs[:6]
                if with_preprocess:
                    new_pipe, out = self.pipe._step_impl(pipe_st, fr, m, g, r, consts)
                else:
                    new_pipe, out = self.pipe._step_core(
                        pipe_st, fr, m, g, r, consts,
                        gray_change=xs[6] if has_cd else None,
                    )
                new_noise, noise_out = fsm_ops.noise_step(noise_st, out.visual_changes)
                return None, (new_pipe, new_noise, out, noise_out)

            xs = (state.pipe, state.noise, frames_or_gray, s2c_mask, s2c_given, refresh)
            if has_cd:
                xs = xs + (gray_cd,)
            # nested_scan: the stream axis gets the same program shape
            # as chunked dispatch (scans of at most 16).
            from chessboard_vision.models.pipeline import nested_scan

            _, (pipe_s, noise_s, outs, nouts) = nested_scan(
                body, None, xs, self.n_streams
            )
            return MultiStreamState(pipe_s, noise_s), MultiStreamOutputs(outs, nouts)

        def core(state: MultiStreamState, gray, gray_cd, s2c_mask, s2c_given, refresh, fconsts):
            pipe_state, out = self.pipe._step_core(
                jax.tree.map(fold, state.pipe),
                fold(gray),
                s2c_mask.reshape(-1),
                jnp.repeat(s2c_given, 64),
                jnp.repeat(refresh, 64),
                fconsts,
                gray_change=None if gray_cd is None else fold(gray_cd),
            )
            pipe_state = jax.tree.map(unfold, pipe_state)
            out = jax.tree.map(unfold, out)
            noise_state, noise_out = jax.vmap(fsm_ops.noise_step)(
                state.noise, out.visual_changes
            )
            return MultiStreamState(pipe_state, noise_state), MultiStreamOutputs(out, noise_out)

        def step_fn(state, frames, s2c_mask, s2c_given, refresh, consts, fconsts, plan_arrays):
            """One tick for all N streams; geometry handled per stream."""
            if self._stream_plans is None:
                if self.mesh is None:
                    return scan_streams(
                        state, frames, None, s2c_mask, s2c_given, refresh, consts, True
                    )
                gray, gray_cd = jax.vmap(self.pipe._preprocess, in_axes=(0, None))(
                    frames, consts
                )
            else:
                gray, gray_cd = self._extract_squares_per_stream(
                    frames, plan_arrays, consts
                )
                if self.mesh is None:
                    return scan_streams(
                        state, gray, gray_cd, s2c_mask, s2c_given, refresh, consts, False
                    )
            return core(state, gray, gray_cd, s2c_mask, s2c_given, refresh, fconsts)

        self._step = jax.jit(step_fn, donate_argnums=(0,))

        def chunk_stream_major(state, frames, s2c_mask, s2c_given, refresh, consts):
            """T ticks x N streams in one dispatch, STREAM-MAJOR: the outer
            scan walks streams; each stream runs the tick scan with ITS
            single-stream state as the (small) carry — exactly the
            single-stream step_many program XLA already compiles to the
            measured per-frame floor. The stacked per-stream state is
            sliced ONCE per chunk per stream (outer scan xs) and written
            once (outer ys) instead of per tick: the tick-major form pays
            a per-tick dynamic-update-slice of the ~30 MB stacked state.
            Streams are independent, so the
            loop interchange is exact: per-(tick, stream) semantics equal
            T sequential step() calls (parity-tested). Frames stay in the
            caller's (T, N, ...) layout; each tick fetches its frame with
            one dynamic_slice (reads only that frame — a host-side
            transpose to stream-major would copy the whole multi-hundred-
            MB chunk buffer instead)."""
            from chessboard_vision.models.pipeline import nested_scan

            t_len = frames.shape[0]
            fdims = frames.shape[2:]  # (3, Hf, Wf) planar or (Hf, Wf, 3) HWC

            def stream_body(_, xs):
                pipe0, noise0, s_idx = xs
                # Tiny per-stream tick inputs: one slice each, fed to the
                # tick scan as xs. The frame buffer is NOT pre-sliced (that
                # would copy T frames per stream); ticks fetch on demand.
                m_s = jax.lax.dynamic_slice(
                    s2c_mask, (0, s_idx, 0), (t_len, 1, 64)
                )[:, 0]
                g_s = jax.lax.dynamic_slice(
                    s2c_given, (0, s_idx), (t_len, 1)
                )[:, 0]
                r_s = jax.lax.dynamic_slice(
                    refresh, (0, s_idx), (t_len, 1)
                )[:, 0]

                def tick_body(carry, tick_xs):
                    p, nz = carry
                    t, m, g, r = tick_xs
                    fr = jax.lax.dynamic_slice(
                        frames, (t, s_idx) + (0,) * len(fdims), (1, 1) + fdims
                    ).reshape(fdims)
                    new_p, out = self.pipe._step_impl(p, fr, m, g, r, consts)
                    new_nz, nout = fsm_ops.noise_step(nz, out.visual_changes)
                    return (new_p, new_nz), (out, nout)

                (pf, nf), (outs, nouts) = nested_scan(
                    tick_body, (pipe0, noise0),
                    (jnp.arange(t_len), m_s, g_s, r_s), t_len,
                )
                return None, (pf, nf, outs, nouts)

            _, (pipe_s, noise_s, outs, nouts) = nested_scan(
                stream_body, None,
                (state.pipe, state.noise, jnp.arange(self.n_streams)),
                self.n_streams,
            )

            def swap(x):  # (N, T, ...) -> the API's (T, N, ...)
                return jnp.swapaxes(x, 0, 1)

            return (
                MultiStreamState(pipe_s, noise_s),
                MultiStreamOutputs(
                    jax.tree.map(swap, outs), jax.tree.map(swap, nouts)
                ),
            )

        def chunk(state, frames, s2c_mask, s2c_given, refresh, consts, fconsts, plan_arrays):
            # Scan over T ticks of the batched step: one dispatch + one
            # small D2H per T x N frames (the same per-dispatch overhead
            # amortization as VisionPipeline.step_many, applied to the
            # batched configuration), through nested_scan like step_many.
            # Shared-geometry single-chip runs take the stream-major form
            # (outer scan over streams — no per-tick stacked-state carry);
            # meshed runs keep tick-major (a stream scan would serialize
            # the sharded axis), and per-stream-geometry mode keeps it too
            # (its static per-stream resample plans cannot be selected by
            # a traced stream index).
            if self._stream_plans is None and self.mesh is None:
                return chunk_stream_major(
                    state, frames, s2c_mask, s2c_given, refresh, consts
                )

            def body(st, xs):
                fr, m, g, r = xs
                st, out = step_fn(st, fr, m, g, r, consts, fconsts, plan_arrays)
                return st, out

            from chessboard_vision.models.pipeline import nested_scan

            xs = (frames, s2c_mask, s2c_given, refresh)
            return nested_scan(body, state, xs, frames.shape[0])

        self._step_chunk = jax.jit(chunk, donate_argnums=(0,))

        def capture_fn(state, frames, consts, plan_arrays):
            if self._stream_plans is None:
                if self.mesh is None:
                    # One device: scan over streams (like step) — keeps
                    # each stream's capture single-stream sized.
                    def body(_, xs):
                        st, fr = xs
                        return None, self.pipe._capture_impl(st, fr, consts)

                    from chessboard_vision.models.pipeline import nested_scan

                    _, new_state = nested_scan(
                        body, None, (state, frames), self.n_streams
                    )
                    return new_state
                return jax.vmap(
                    lambda st, fr, c: self.pipe._capture_impl(st, fr, c),
                    in_axes=(0, 0, None),
                )(state, frames, consts)
            gray, gray_cd = self._extract_squares_per_stream(
                frames, plan_arrays, consts
            )
            return jax.vmap(self.pipe._capture_core)(
                state, gray, gray if gray_cd is None else gray_cd
            )

        self._capture = jax.jit(capture_fn)

    def _tile(self, x):
        """(64, ...) per-square constant -> (N*64, ...), stream-major (the
        fold order of jax.tree.map(fold, state): stream s, square q ->
        s*64 + q)."""
        x = jnp.asarray(x)
        return jnp.tile(x, (self.n_streams,) + (1,) * (x.ndim - 1))

    def _extract_squares_per_stream(self, frames, plan_arrays, consts):
        """(N, 3, Hf, Wf) planar frames -> ((N, 64, H, W) preprocessed gray,
        change-detector gray or None), each stream resampled with ITS
        static plan (static slices stay static — a vmapped dynamic variant
        would turn them into gathers), then one batched
        Gaussian over all streams. plan_arrays are traced jit arguments;
        the matching static dims come from self._plan_dims.

        with_enhancer: the per-stream plans are frame->board TILE plans;
        each stream's color board is warped with its own plan, enhanced
        (models/enhancer.enhance_planar — the same fused 5-stage program
        the single-stream path runs), grayscaled, and the padded squares
        extracted with the SHARED board-space plan (consts.enh_ext_plan —
        grid structure is shared across streams by construction)."""
        from chessboard_vision.ops import matmul_resample as mr
        from chessboard_vision.ops.color import planar_bgr2gray
        from chessboard_vision.ops.filters import gaussian_blur_valid

        if self.pipe.with_enhancer:
            bsize = self.pipe.geometry.board_size
            # Each stream warps with ITS tile plan, then runs the
            # pipeline's own enhance->gray->pad->extract tail
            # (VisionPipeline._enhanced_board_squares) — one copy of the
            # sequence, so single-stream/batched bit-parity is structural.
            squares = jnp.stack([
                self.pipe._enhanced_board_squares(
                    mr.warp_board_color(
                        frames[i], plan, dims,
                        self.pipe._tile_starts, bsize,
                    ),
                    consts.enh_ext_plan,
                )
                for i, (plan, dims) in enumerate(zip(plan_arrays, self._plan_dims))
            ])  # (N, 64, H+2p, W+2p)
        else:
            gray_frames = planar_bgr2gray(frames)  # (N, Hf, Wf)
            squares = jnp.stack([
                mr.resample_gray_u8(gray_frames[i], plan, dims)
                for i, (plan, dims) in enumerate(zip(plan_arrays, self._plan_dims))
            ])  # (N, 64, H+2p, W+2p)
        # pad must match the single-stream preprocess (pipeline.py), else
        # geometries built with blur_pad != 2 misalign vs masks/ref shapes
        gray = gaussian_blur_valid(squares, 5, pad=self.pipe._pad)
        if self.pipe.change_blur != 5:
            gray_cd = gaussian_blur_valid(
                squares, self.pipe.change_blur, pad=self.pipe._pad
            )
        else:
            gray_cd = None
        return gray, gray_cd

    def init_state(self) -> MultiStreamState:
        def stack(leaf):
            return jnp.broadcast_to(leaf, (self.n_streams,) + leaf.shape)

        pipe0 = self.pipe.init_state()
        state = MultiStreamState(
            pipe=jax.tree.map(stack, pipe0),
            noise=jax.tree.map(stack, fsm_ops.init_state()),
        )
        if self.mesh is not None:
            if "space" in self.mesh.axis_names and self.mesh.shape["space"] > 1:
                # 2-D placement: streams over "data", the 64-square axis
                # over "space" (spatial/model parallelism — XLA inserts the
                # all-gathers the per-stream FSM reduction needs).
                state = mesh_lib.shard_pytree_stream_square(state, self.mesh)
            else:
                state = mesh_lib.shard_pytree_leading_axis(state, self.mesh)
        return state

    def _prep_frames(self, frames):
        """Host HWC -> planar conversion for the per-stream-geometry mode
        (its extraction path is planar-only); shared-geometry mode accepts
        both layouts (the HWC branch is the bit-exact oracle path)."""
        if (
            self._stream_plans is not None
            and hasattr(frames, "ndim")
            and frames.ndim == 4
            and frames.shape[-1] == 3
            and frames.shape[-3] != 3
        ):
            # Layout detected by shape, not array type: a jnp HWC batch
            # must not silently take the planar path (it would fail with
            # a shape error deep inside the jitted extraction).
            if isinstance(frames, np.ndarray):
                from chessboard_vision.ops import static_resample as sr

                frames = np.stack([sr.to_planar(f) for f in frames])
            else:
                frames = jnp.moveaxis(frames, -1, -3)
        return self._place(frames)

    def capture_reference(self, state: MultiStreamState, frames) -> MultiStreamState:
        pipe = self._capture(
            state.pipe, self._prep_frames(frames), self.pipe._consts, self._plan_arrays
        )
        return MultiStreamState(pipe=pipe, noise=state.noise)

    def _place(self, arr):
        if self.mesh is None:
            return jnp.asarray(arr)
        sharding = mesh_lib.stream_sharding(self.mesh, axis="data")
        if jax.process_count() > 1:
            # Multi-host fleet: each process passes only its OWN rigs'
            # frames (n_streams / process_count of them); they are
            # assembled into the global batch without any host ever
            # materializing the fleet's frames (scaling-book recipe;
            # parallel/distributed.distribute_local_streams).
            local = np.asarray(arr)
            n_local = self.n_streams // jax.process_count()
            if local.shape[0] == n_local:
                return jax.make_array_from_process_local_data(
                    sharding, local, (self.n_streams,) + local.shape[1:]
                )
        return jax.device_put(arr, sharding)

    def step(
        self,
        state: MultiStreamState,
        frames,
        s2c_masks=None,
        refresh=None,
    ):
        """One tick for all N streams. frames: (N, H, W, 3) u8."""
        n = self.n_streams
        frames = self._prep_frames(frames)
        if s2c_masks is None:
            s2c_mask = jnp.zeros((n, 64), bool)
            s2c_given = jnp.zeros((n,), bool)
        else:
            s2c_mask = jnp.asarray(s2c_masks)
            s2c_given = jnp.ones((n,), bool)
        if refresh is None:
            refresh = jnp.zeros((n,), bool)
        else:
            refresh = jnp.asarray(refresh)
        return self._step(
            state, frames, s2c_mask, s2c_given, refresh, self.pipe._consts,
            self._folded_consts, self._plan_arrays,
        )

    def step_chunk(self, state: MultiStreamState, frames):
        """T ticks for all N streams in ONE device dispatch.

        frames: (T, N, 3, H, W) planar u8 (or (T, N, H, W, 3) HWC host
        array). Outputs have leading (T, N) axes. Tick semantics are
        scan-exact vs T sequential step() calls."""
        if (
            self._stream_plans is not None
            and hasattr(frames, "ndim")
            and frames.ndim == 5
            and frames.shape[-1] == 3
            and frames.shape[-3] != 3
        ):
            # per-stream-geometry extraction is planar-only (same
            # conversion step()/_prep_frames applies per tick); layout
            # detected by shape so HWC device arrays convert too
            if isinstance(frames, np.ndarray):
                from chessboard_vision.ops import static_resample as sr

                frames = np.stack(
                    [np.stack([sr.to_planar(f) for f in tick]) for tick in frames]
                )
            else:
                frames = jnp.moveaxis(frames, -1, -3)
        frames = jnp.asarray(frames)
        t, n = frames.shape[0], self.n_streams
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            frames = jax.device_put(
                frames, NamedSharding(self.mesh, P(None, "data"))
            )
        masks = jnp.zeros((t, n, 64), bool)
        givens = jnp.zeros((t, n), bool)
        refreshes = jnp.zeros((t, n), bool)
        return self._step_chunk(
            state, frames, masks, givens, refreshes, self.pipe._consts,
            self._folded_consts, self._plan_arrays,
        )
