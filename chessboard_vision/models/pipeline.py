"""The fused frame->occupancy pipeline: one XLA call per frame.

Accelerator redesign of the reference per-frame hot loop (game_session.py
on_frame :113-179 minus UI): warp (precomputed-gather bilinear), 8x8 square
extraction with baked-in blur borders, grayscale + Gaussian preprocess,
the full piece-detection cascade with delta-cache/history state, and the
EMA change detector — all inside a single jitted step with donated state,
so the per-frame host<->device traffic is exactly one H2D (the camera
frame) and one small D2H (per-square outputs), per SURVEY.md §7.

The temporal state (visual references, result cache, detection history,
background model) is an explicit PipelineState pytree: step(state, frame)
-> (state, outputs). Host keeps: rules, FSMs, Lichess, UI.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from chessboard_vision.geometry import BoardGeometry
from chessboard_vision.ops import warp as warp_ops
from chessboard_vision.ops import change as change_ops
from chessboard_vision.ops import hough as hough_ops
from chessboard_vision.ops import hough_conv as hough_conv_ops
from chessboard_vision.ops import piece as piece_ops
from chessboard_vision.ops.color import bgr2gray, planar_bgr2gray
from chessboard_vision.ops.filters import gaussian_blur_valid
from chessboard_vision.ops import static_resample as sr
from chessboard_vision.ops import matmul_resample as mr
from chessboard_vision.ops.layout import positions_to_mask  # noqa: F401  (re-export)
from chessboard_vision.models import piece_detector as pd_model
from chessboard_vision.models.enhancer import enhance_planar
from chessboard_vision.platform import default_hough_backend


class PipelineState(NamedTuple):
    piece: pd_model.PieceState
    change: change_ops.ChangeModelState


class StepConsts(NamedTuple):
    """Device constants passed as jit ARGUMENTS, not closure literals.

    Closing over multi-MB arrays (the Hough basis matrix alone is tens of
    MB) embeds them as literals in the jaxpr/HLO, which multiplies XLA
    compile time and bloats every derived program; as arguments they are
    ordinary device buffers hashed by shape."""

    dg: warp_ops.DeviceGeometry
    masks: piece_ops.PieceMasks
    params: hough_ops.HoughParams
    conv_plan: Optional[hough_conv_ops.ConvHoughPlan]
    mm_plan: mr.MatmulResamplePlan
    # with_enhancer path only (None otherwise): board-tile color warp plan
    # and the exact board->squares extraction plan.
    enh_tile_plan: Optional[mr.MatmulResamplePlan] = None
    enh_ext_plan: Optional[mr.MatmulResamplePlan] = None


class StepOutputs(NamedTuple):
    occupancy: jnp.ndarray  # (64,) bool — smoothed has_piece per square
    raw_occupancy: jnp.ndarray  # (64,) bool
    visual_changes: jnp.ndarray  # (64,) bool
    method: jnp.ndarray  # (64,) i32
    confidence: jnp.ndarray  # (64,) f32
    radius: jnp.ndarray  # (64,) i32
    change_intensity: jnp.ndarray  # (64,) i32 (0 if change detection off)
    change_pct: jnp.ndarray  # (64,) f32
    change_z_peak: jnp.ndarray  # (64,) f32
    center_mean: jnp.ndarray  # (64,) f32 — mean gray over the center disc
    corner_mean: jnp.ndarray  # (64,) f32 — mean gray over the corner
    # (background) regions. center/corner feed the host-side light/dark
    # piece-color classifier (rules.classify_piece_colors -> colored FEN);
    # the corner mean normalizes out illumination (shadow/glare).
    profile_extent: jnp.ndarray  # (64,) f32 — ring-coverage piece-size
    # profile in [0, 4] (-1 invalid), from reductions the cascade already
    # computes (ops/piece.py). Second feature of the piece-TYPE classifier
    # (rules/piece_types.py): sub-pixel, and available on squares the
    # cascade resolved WITHOUT a circle (center_diff/symmetry), which
    # carry only a fallback radius. Adds 256 B to the per-frame D2H —
    # measured invisible on the latency-dominated readback path.


def nested_scan(body, state, xs, length: int, inner: int = 16):
    """lax.scan of ``body`` over ``xs``, nested as scans-of-``inner`` so no
    flat scan is longer than ``inner``. Semantically identical to one flat
    scan (parity-tested): k = groups*inner + rem runs a scan-of-scans over
    the groups and a short flat scan over the remainder, outputs
    concatenated. ``inner=0`` is the flat scan.

    Shared by VisionPipeline._steps_impl and MultiStreamPipeline's chunk
    so the program shape of every chunked dispatch is decided here. A flat
    scan of 64 steps compiles and runs on the GPU as well; whether the
    nesting still earns its place is an open question (ROADMAP)."""
    k = length
    if not inner or k <= inner:
        return jax.lax.scan(body, state, xs)
    groups, rem = divmod(k, inner)
    head = jax.tree.map(lambda x: x[: k - rem], xs)

    def regroup(x):
        return x.reshape((groups, inner) + x.shape[1:])

    def outer(st, xg):
        return jax.lax.scan(body, st, xg)

    # The outer scan recurses through nested_scan too, so for
    # k >= inner**2 (e.g. --chunk 512 at inner 16) no scan exceeds inner.
    state, outs = nested_scan(
        outer, state, jax.tree.map(regroup, head), groups, inner
    )
    outs = jax.tree.map(lambda x: x.reshape((k - rem,) + x.shape[2:]), outs)
    if rem:
        tail = jax.tree.map(lambda x: x[k - rem :], xs)
        state, touts = jax.lax.scan(body, state, tail)
        outs = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=0), outs, touts
        )
    return state, outs


class VisionPipeline:
    """Compiled frame->occupancy pipeline for one calibration geometry.

    Geometry-derived constants (gather maps, masks, Hough params) are baked
    into the compiled step; recalibrating builds a new pipeline.
    """

    def __init__(
        self,
        geometry: BoardGeometry,
        piece_settings: Optional[dict] = None,
        with_change_detector: bool = True,
        change_settings: Optional[dict] = None,
        donate_state: bool = True,
        hough_backend: str = "auto",
        with_enhancer: bool = False,
        enhancer_profile: Optional[dict] = None,
        detector_overrides: Optional[dict] = None,
    ):
        self.geometry = geometry
        self.dg = warp_ops.DeviceGeometry.from_host(geometry)
        s = geometry.squares
        heights, widths = s.heights, s.widths
        self.H, self.W = int(heights.max()), int(widths.max())

        min_ratio, max_ratio = 0.20, 0.55
        if piece_settings:
            if "min_radius" in piece_settings:
                min_ratio = piece_settings["min_radius"] / 100.0
            if "max_radius" in piece_settings:
                max_ratio = piece_settings["max_radius"] / 100.0
        self.masks = piece_ops.PieceMasks.build(heights, widths, self.H, self.W)
        self.params, self.bounds = hough_ops.HoughParams.from_geometry(
            heights, widths, min_ratio=min_ratio, max_ratio=max_ratio
        )
        # Backend seam (the reference's accelerated-impl alias pattern,
        # frame_enhancer.py:184-190): 'exact' is the cv2-faithful voting
        # transform; 'conv' the annular-correlation detector. 'auto' is
        # the platform's measured choice (platform.default_hough_backend).
        if hough_backend == "auto":
            hough_backend = default_hough_backend()
        self.hough_backend = hough_backend
        if hough_backend == "conv":
            # Bounded hysteresis (2 rounds, reach 8) on the conv path: the
            # exact fixpoint's lax.while_loop costs are content-dependent;
            # decision agreement with the full Canny is 100% on the fixture
            # sweep at >=1 round (tests/test_hough_conv.py).
            self.conv_plan, self.conv_dims = hough_conv_ops.ConvHoughPlan.build(
                heights, widths, min_ratio=min_ratio, max_ratio=max_ratio,
                plane_h=self.H, plane_w=self.W, hysteresis_rounds=2,
            )
        else:
            self.conv_plan, self.conv_dims = None, None
        self._pad = geometry.squares.pad
        qx, qy = geometry.square_query_coords()
        self._mm_plan, self._mm_dims = mr.build_plan(qx, qy, geometry.src_h, geometry.src_w)

        # Optional fused enhancement ahead of detection (reference
        # frame_enhancer.py:161-181 run on the warped board, the
        # stage game_session.py:86 constructs but never wires into the
        # loop). Needs a COLOR board: a second matmul-resample plan warps
        # the frame to 64 overlapping board tiles per channel, the enhanced
        # board is grayscaled, and a third (integer-coordinate, bit-exact)
        # plan extracts the padded squares from board space.
        self.with_enhancer = with_enhancer
        self.enhancer_profile = dict(enhancer_profile) if enhancer_profile else {}
        if with_enhancer:
            tqx, tqy, self._tile_starts, _ = geometry.board_tile_query_coords()
            enh_tile_plan, self._tile_dims = mr.build_plan(
                tqx, tqy, geometry.src_h, geometry.src_w
            )
            # Integer query coords = the square gather maps themselves, so
            # the mm resample reproduces board[sq_iy, sq_ix] exactly. src is
            # declared one pixel larger (and the board edge-padded at run
            # time) so the +1 bilinear tap of last-row/col anchors stays in
            # range instead of tripping the out-of-source zero mask.
            s = geometry.squares
            enh_ext_plan, self._ext_dims = mr.build_plan(
                s.ix.astype(np.float32), s.iy.astype(np.float32),
                geometry.board_size + 1, geometry.board_size + 1,
            )
        else:
            enh_tile_plan = enh_ext_plan = None
            self._tile_dims = self._ext_dims = self._tile_starts = None

        self.with_change = with_change_detector
        cs = change_settings or {}
        self.z_threshold = float(cs.get("z_threshold", 2.5))
        self.initial_variance = float(cs.get("initial_variance", 100.0))
        self.alpha = float(cs.get("alpha", 0.1))
        # The change detector's own preprocessing blur (reference
        # change_detector.py:49-56 takes a configurable odd kernel; the
        # piece path keeps its fixed 5). Kernels above 5 need a geometry
        # built with a wider baked-in border (blur_pad >= kernel//2).
        self.change_blur = int(cs.get("blur_kernel", 5))
        if self.change_blur % 2 == 0:
            raise ValueError(f"blur_kernel must be odd, got {self.change_blur}")
        if self.change_blur // 2 > self._pad:
            raise ValueError(
                f"blur_kernel {self.change_blur} needs geometry blur_pad >= "
                f"{self.change_blur // 2} (have {self._pad}); rebuild with "
                f"BoardGeometry.from_calibration(..., blur_pad={self.change_blur // 2})"
            )

        # Detector threshold overrides for the calibrator tools ONLY. The
        # settings-file quirk is preserved (piece_settings JSON honors just
        # min/max radius, reference piece_detector.py:58-65); the reference
        # calibrator bypasses load_settings by assigning detector attributes
        # directly (calibrate_piece_detector.py:139-335) — this is that
        # seam. Recognized keys: hough_param1, hough_param2,
        # center_diff_threshold. Both hough backends share param2's
        # vote-count semantics (the conv backend verifies its proposal
        # with cv2-style ray votes — ops/hough_conv.find_circle).
        ov = detector_overrides or {}
        self._det_kwargs = {}
        if "hough_param1" in ov:
            self._det_kwargs["hough_param1"] = int(ov["hough_param1"])
        if "hough_param2" in ov:
            self._det_kwargs["hough_param2"] = int(ov["hough_param2"])
        if "center_diff_threshold" in ov:
            self._det_kwargs["center_diff_threshold"] = float(ov["center_diff_threshold"])

        # Constant device inputs reused across steps (avoid per-frame H2D).
        self._zero_mask64 = jnp.zeros((64,), bool)
        self._false = jnp.asarray(False)
        self._true = jnp.asarray(True)

        self._consts = StepConsts(
            dg=self.dg,
            masks=self.masks,
            params=self.params,
            conv_plan=self.conv_plan,
            mm_plan=self._mm_plan,
            enh_tile_plan=enh_tile_plan,
            enh_ext_plan=enh_ext_plan,
        )

        donate = (0,) if donate_state else ()
        self._step = jax.jit(
            partial(self._step_impl),
            static_argnames=("use_smoothing", "use_delta"),
            donate_argnums=donate,
        )
        self._step_many = jax.jit(
            partial(self._steps_impl),
            static_argnames=("use_smoothing", "use_delta", "inner_chunk"),
            donate_argnums=donate,
        )
        self._preprocess_j = jax.jit(self._preprocess)
        self._capture_j = jax.jit(self._capture_impl)

    # -- core device functions ------------------------------------------

    def _preprocess(self, frame: jnp.ndarray, consts: StepConsts) -> jnp.ndarray:
        """frame -> preprocessed gray squares (64, H, W) u8.

        Accepts (3, Hf, Wf) planar u8 (the banded-matmul resample path,
        gray-first — host numpy HWC frames are converted to it by step())
        or (Hf, Wf, 3) HWC device arrays (the XLA-gather path, bit-exact
        channel-wise warp for the oracle parity tests).
        Gray conversion is linear, so the two differ only by per-channel
        u8 rounding order (<=1 intensity level; decisions unaffected).

        with_enhancer inserts the 5-stage enhancement on the warped COLOR
        board before grayscale + detection (still one XLA call): planar
        frames ride the board-tile matmul warp, HWC frames the exact
        gather warp.
        """
        planar_in = frame.ndim == 3 and frame.shape[0] == 3
        if self.with_enhancer:
            if planar_in:
                board = mr.warp_board_color(
                    frame, consts.enh_tile_plan, self._tile_dims,
                    self._tile_starts, self.geometry.board_size,
                )  # (3, B, B) u8
            else:
                board = jnp.moveaxis(warp_ops.frame_to_board(frame, consts.dg), -1, 0)
            gray_padded = self._enhanced_board_squares(board, consts.enh_ext_plan)
        elif planar_in:
            gray_frame = planar_bgr2gray(frame)
            gray_padded = mr.resample_gray_u8(gray_frame, consts.mm_plan, self._mm_dims)
        else:
            board = warp_ops.frame_to_board(frame, consts.dg)
            squares_padded = warp_ops.extract_squares(board, consts.dg)
            gray_padded = bgr2gray(squares_padded)
        gray = gaussian_blur_valid(gray_padded, 5, pad=self._pad)  # (64, H, W)
        if self.change_blur != 5:
            gray_cd = gaussian_blur_valid(gray_padded, self.change_blur, pad=self._pad)
        else:
            gray_cd = gray
        return gray, gray_cd

    def _enhanced_board_squares(
        self, board: jnp.ndarray, ext_plan
    ) -> jnp.ndarray:
        """Warped color board (3, B, B) u8 -> enhanced PADDED gray squares
        (64, H+2p, W+2p) u8: the enhance -> grayscale -> edge-pad ->
        board-space extraction tail of the enhancer preprocess. The SINGLE
        source of this sequence — the batched path (parallel/multistream
        ``_extract_squares_per_stream``) calls it per stream, so
        single-stream/batched bit-parity is structural, not by-comment."""
        board = enhance_planar(board, self.enhancer_profile)
        grayb = planar_bgr2gray(board)  # (B, B) u8
        grayb = jnp.pad(grayb, ((0, 1), (0, 1)), mode="edge")
        return mr.resample_gray_u8(grayb, ext_plan, self._ext_dims)

    def _step_impl(
        self,
        state: PipelineState,
        frame: jnp.ndarray,
        s2c_mask: jnp.ndarray,
        s2c_given: jnp.ndarray,
        refresh_refs: jnp.ndarray,
        consts: Optional[StepConsts] = None,
        use_smoothing: bool = True,
        use_delta: bool = True,
    ):
        if consts is None:  # convenience for direct (non-jitted) callers
            consts = self._consts
        gray, gray_cd = self._preprocess(frame, consts)
        return self._step_core(
            state, gray, s2c_mask, s2c_given, refresh_refs, consts,
            use_smoothing=use_smoothing, use_delta=use_delta, gray_change=gray_cd,
        )

    def _step_core(
        self,
        state: PipelineState,
        gray: jnp.ndarray,
        s2c_mask: jnp.ndarray,
        s2c_given: jnp.ndarray,
        refresh_refs: jnp.ndarray,
        consts: StepConsts,
        use_smoothing: bool = True,
        use_delta: bool = True,
        gray_change: Optional[jnp.ndarray] = None,
    ):
        """Everything after preprocessing: detection cascade, change model,
        temporal state. Split out so callers with their own square
        extraction (per-stream calibration geometries in the batched
        pipeline) can vmap the geometry-independent core. ``gray_change``
        is the change detector's own-blur preprocessing (defaults to the
        shared 5-kernel gray)."""
        # Post-move forced re-reference (reference game_session.py:221:
        # update_references + cache clear), applied with this frame's gray
        # inside the same XLA call so the noise FSM sees no phantom changes.
        # refresh_refs: () scalar (whole-board refresh) or a per-square
        # vector (the stream-folded batched pipeline, where each stream's
        # 64 squares carry that stream's flag).
        # ONE flatten of gray serves the piece ref compare/update AND (for
        # the default shared-blur config) the change ops — XLA does not
        # CSE duplicate reshapes across fusions, and the flat (64, P)
        # piece/change state never pays a donated-carry relayout copy
        # (ops/change.ChangeModelState).
        gray_flat = change_ops.flatten_pixels(gray)
        p = state.piece
        refresh_px = (
            refresh_refs if jnp.ndim(refresh_refs) == 0
            else refresh_refs[:, None]
        )
        piece_in = p._replace(
            ref_gray=jnp.where(refresh_px, gray_flat, p.ref_gray),
            has_ref=jnp.where(refresh_refs, True, p.has_ref),
            has_cache=jnp.where(refresh_refs, False, p.has_cache),
        )

        piece_state, det = pd_model.detect_all(
            piece_in,
            gray,
            consts.masks,
            consts.params,
            self.bounds,
            s2c_mask,
            s2c_given,
            use_smoothing=use_smoothing,
            use_delta=use_delta,
            hough_backend=self.hough_backend,
            conv_plan=consts.conv_plan,
            conv_dims=self.conv_dims,
            gray_flat=gray_flat,
            **self._det_kwargs,
        )

        if self.with_change:
            gcd = (
                gray_flat if gray_change is None
                else change_ops.flatten_pixels(gray_change)
            )
            cdet = change_ops.detect(
                state.change, gcd, self.z_threshold,
                consts.dg.sq_mask_flat, consts.dg.sq_counts,
            )
            change_state = change_ops.update_references(
                state.change, gcd, self.alpha, jnp.ones((gcd.shape[0],), bool)
            )
            intensity, pct, zpeak = cdet.intensity, cdet.pct_changed, cdet.z_peak
        else:
            change_state = state.change
            n = gray.shape[0]
            intensity = jnp.zeros((n,), jnp.int32)
            pct = jnp.zeros((n,), jnp.float32)
            zpeak = jnp.zeros((n,), jnp.float32)

        outputs = StepOutputs(
            occupancy=det.has_piece,
            raw_occupancy=det.raw_has_piece,
            visual_changes=det.visual_changes,
            method=det.method,
            confidence=det.confidence,
            radius=det.radius,
            change_intensity=intensity,
            change_pct=pct,
            change_z_peak=zpeak,
            # From the cascade's fused pass-1 reduce — bit-identical to
            # masked_mean over the same masks (exact integer sums), with
            # no extra pass over gray.
            center_mean=det.center_mean,
            corner_mean=det.border_mean,
            profile_extent=det.extent,
        )
        return PipelineState(piece=piece_state, change=change_state), outputs

    def _steps_impl(
        self,
        state: PipelineState,
        frames: jnp.ndarray,
        s2c_masks: jnp.ndarray,
        s2c_givens: jnp.ndarray,
        refreshes: jnp.ndarray,
        consts: Optional[StepConsts] = None,
        use_smoothing: bool = True,
        use_delta: bool = True,
        inner_chunk: int = 0,
    ):
        """lax.scan of _step_impl over a (K, ...) frame chunk.

        One dispatch + ONE small D2H per K frames instead of per frame:
        per-dispatch and readback latency amortize K-fold while per-frame
        semantics (delta cache, smoothing history, EMA model, refresh) stay
        identical to K sequential step() calls — parity-tested in
        tests/test_pipeline_e2e.py.

        inner_chunk > 0 nests the scan as scans-of-inner_chunk (see
        nested_scan — non-multiple K runs the remainder as a short flat
        scan). Semantically identical to the flat scan.
        """
        if consts is None:
            consts = self._consts

        def body(st, xs):
            fr, m, g, r = xs
            st, out = self._step_impl(
                st, fr, m, g, r, consts,
                use_smoothing=use_smoothing, use_delta=use_delta,
            )
            return st, out

        xs = (frames, s2c_masks, s2c_givens, refreshes)
        return nested_scan(body, state, xs, frames.shape[0], inner_chunk)

    def _capture_impl(self, state: PipelineState, frame: jnp.ndarray,
                      consts: StepConsts) -> PipelineState:
        gray, gray_cd = self._preprocess(frame, consts)
        return self._capture_core(state, gray, gray_cd)

    def _capture_core(self, state: PipelineState, gray: jnp.ndarray,
                      gray_change: Optional[jnp.ndarray] = None) -> PipelineState:
        piece = pd_model.update_references(state.piece, gray)
        gcd = gray if gray_change is None else gray_change
        change = change_ops.calibrate(gcd, self.initial_variance)
        return PipelineState(piece=piece, change=change)

    # -- host API --------------------------------------------------------

    def init_state(self) -> PipelineState:
        shape = (64, self.H, self.W)
        return PipelineState(
            piece=pd_model.init_state(shape),
            change=change_ops.init_state(shape),
        )

    def capture_reference(self, state: PipelineState, frame) -> PipelineState:
        """Set visual references from a frame (reference capture_reference,
        game_session.py:93-111: update_references on the piece detector;
        calibrates the change model too)."""
        if isinstance(frame, np.ndarray) and frame.ndim == 3 and frame.shape[-1] == 3:
            frame = sr.to_planar(frame)
        return self._capture_j(state, jnp.asarray(frame), self._consts)

    def step(
        self,
        state: PipelineState,
        frame,
        squares_to_check=None,
        refresh_refs: bool = False,
        use_smoothing: bool = True,
        use_delta: bool = True,
    ):
        """Process one frame. squares_to_check: optional set of (file, rank);
        refresh_refs forces a visual re-reference from this frame first.

        Host numpy frames in camera HWC layout are converted to the planar
        (3, H, W) fast-path layout before upload; device arrays are used
        as-is (pass planar for the fast path)."""
        if isinstance(frame, np.ndarray) and frame.ndim == 3 and frame.shape[-1] == 3:
            frame = sr.to_planar(frame)
        if squares_to_check is None:
            s2c_mask = self._zero_mask64
            s2c_given = self._false
        else:
            s2c_mask = jnp.asarray(positions_to_mask(squares_to_check))
            s2c_given = self._true
        # consts stay jit ARGUMENTS (StepConsts docstring): baking them as
        # closure constants embeds the ~45 MB Hough basis as an HLO literal
        # AND lets XLA constant-fold/contract the f32 arithmetic
        # differently between the flat and nested scan programs, breaking
        # step_many's scan-exactness (test_step_many_nested_scan_matches_flat).
        return self._step(
            state,
            jnp.asarray(frame),
            s2c_mask,
            s2c_given,
            self._true if refresh_refs else self._false,
            self._consts,
            use_smoothing=use_smoothing,
            use_delta=use_delta,
        )

    def step_many(
        self,
        state: PipelineState,
        frames,
        squares_to_check=None,
        refresh_first: bool = False,
        use_smoothing: bool = True,
        use_delta: bool = True,
        inner_chunk: int = 0,
    ):
        """Process a chunk of K frames in ONE device dispatch.

        frames: (K, 3, H, W) planar u8 (device array for the fast path) or
        (K, H, W, 3) host HWC. Outputs are StepOutputs with a leading (K,)
        axis. squares_to_check applies to every frame of the chunk;
        refresh_first forces a visual re-reference from frame 0 only.
        inner_chunk nests the scan (see _steps_impl); chunks of 32 or more
        frames default to scans of 16.
        """
        if isinstance(frames, np.ndarray) and frames.ndim == 4 and frames.shape[-1] == 3:
            frames = np.stack([sr.to_planar(f) for f in frames])
        frames = jnp.asarray(frames)
        k = frames.shape[0]
        if inner_chunk == 0 and k >= 32:
            inner_chunk = 16  # nested_scan handles non-multiple K
        if squares_to_check is None:
            masks = jnp.zeros((k, 64), bool)
            givens = jnp.zeros((k,), bool)
        else:
            masks = jnp.broadcast_to(
                jnp.asarray(positions_to_mask(squares_to_check)), (k, 64)
            )
            givens = jnp.ones((k,), bool)
        refreshes = jnp.zeros((k,), bool)
        if refresh_first:
            refreshes = refreshes.at[0].set(True)
        return self._step_many(
            state, frames, masks, givens, refreshes, self._consts,
            use_smoothing=use_smoothing, use_delta=use_delta,
            inner_chunk=inner_chunk,
        )

    def warp_board(self, frame) -> np.ndarray:
        """Warped top-down board image (UI / calibration path)."""
        return np.asarray(warp_ops.frame_to_board(jnp.asarray(frame), self.dg))


def occupancy_to_set(occ) -> set:
    """(64,) bool (chess-index order) -> {(file, rank)} set."""
    occ = np.asarray(occ)
    return {(sq % 8, sq // 8) for sq in range(64) if occ[sq]}


