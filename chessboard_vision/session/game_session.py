"""GameSession — per-frame orchestration, stability gating, move inference.

Behavioral equivalent of reference game_session.py, rebuilt around the
fused device pipeline: on_frame does ONE pipeline step (a single XLA call)
instead of per-square OpenCV work, then runs the host-side control plane:
noise FSM, occupancy-stability gate (20 frames / 2 s cooldown / >4-diff
reset), legal-move inference with ambiguity rejection, and the
on_move_detected subclass hook. Thread safety matches the reference:
``board_lock`` (RLock) is held across inference+push and by the Lichess
stream thread's state sync.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from chessboard_vision import geometry as geo
from chessboard_vision.models.pipeline import VisionPipeline, occupancy_to_set
from chessboard_vision.rules import chess, GameState
from chessboard_vision.session.inference import infer_move_from_diff
from chessboard_vision.session.noise import NoiseHandler, NoiseState
from chessboard_vision.utils.config import (
    CALIBRATION_FILE,
    PIECE_SETTINGS_FILE,
    SENSITIVITY_FILE,
    load_json_config,
)
from chessboard_vision.utils.logging import get_logger
from chessboard_vision.utils.profiling import FpsCounter


class GameSession:
    STATE_IDLE = "IDLE"
    STATE_WAITING = "WAITING"
    STATE_PROCESSING = "PROCESSING"

    STABILITY_REQUIRED = 20  # stable frames before committing a move
    MOVE_COOLDOWN = 2.0  # seconds after a committed move
    FULL_SCAN_PERIOD = 30  # full 64-square scan every Nth frame

    def __init__(self, headless: bool = False, compat_visual_rank_quirk: bool = False):
        self.status = self.STATE_IDLE
        self.config: Optional[dict] = None
        # Keys merged over any calibration config at configure() time —
        # the CLI drivers' hook for flags like --auto-recalibrate.
        self.default_config_overrides: dict = {}
        self.board_lock = threading.RLock()
        self.headless = headless
        # Reference quirk (game_session.py:151-154): legal-move destinations
        # were added to the smart-scan set with a *visual* rank (7 - rank).
        # Fixed by default; enable for bug-compatible scanning.
        self.compat_visual_rank_quirk = compat_visual_rank_quirk

        self.pipeline: Optional[VisionPipeline] = None
        self.pipe_state = None
        self.game: Optional[GameState] = None
        self.noise: Optional[NoiseHandler] = None

        self.player_color = None
        self.orientation_flipped = False

        self.fps = FpsCounter()
        self.frame_count = 0

        self.stable_occupancy = None
        self.stable_count = 0
        self.last_move_time = 0.0
        self.last_move_frame = -(10**9)
        # Post-move cooldown basis. Live cameras use wall seconds
        # (MOVE_COOLDOWN — frame time IS wall time there). For recorded
        # sources processed faster than realtime, wall seconds are WRONG:
        # two moves 3 video-seconds apart can be processed < 2 wall-
        # seconds apart and the second would be silently dropped. Set
        # cooldown_frames (e.g. int(2.0 * video_fps) — process_video does)
        # to count source frames instead.
        self.cooldown_frames: Optional[int] = None

        self.current_radar_destinations = []
        self.lifted_piece_square = None
        self.last_outputs = None
        self._refresh_next = False
        # Piece-TYPE classification (rules/piece_types.py): rolling window
        # of per-square radii from frames whose vision occupancy matches
        # the rules board (stale/transition frames excluded), reset
        # whenever the expected position changes.
        from collections import deque

        self._radius_window = deque(maxlen=8)
        self._extent_window = deque(maxlen=8)  # profile_extent, in lockstep
        self._radius_window_occ = None
        self.piece_types = None
        self.log = get_logger("session")

    # -- calibration -----------------------------------------------------

    def on_calibration_requested(self, cap, config: Optional[dict] = None) -> bool:
        """Calibrate from a provided config dict, a saved calibration.json,
        or the interactive calibration tool (when a camera is given)."""
        if config is None:
            config = load_json_config(CALIBRATION_FILE)
        if config is None and cap is not None:
            from chessboard_vision.tools.calibration_module import CalibrationModule

            config = CalibrationModule().run(cap)
        if config is None:
            return False
        self.configure(config)
        if cap is not None:
            self.capture_reference(cap)
        return True

    def configure(self, config: dict):
        """Build the pipeline and control-plane components from calibration."""
        if self.default_config_overrides:
            config = {**config, **self.default_config_overrides}
        self.config = config
        self.player_color = config.get("player_color")
        self.orientation_flipped = config.get("orientation_flipped", False)
        geometry = geo.BoardGeometry.from_config(config)
        piece_settings = load_json_config(PIECE_SETTINGS_FILE)
        # Unlike the reference (which saved sensitivity_settings.json but
        # never loaded it — SURVEY.md §5 quirk), the tuned change-detector
        # settings are honored here.
        change_settings = load_json_config(SENSITIVITY_FILE)
        # "use_enhancer": true in calibration.json fuses the 5-stage
        # enhancement ahead of detection in the SAME device step. The
        # reference constructed its enhancer but never invoked it in the
        # live loop (SURVEY.md §3.5; reference game_session.py:86) — here
        # the capability is reachable from config. The color profile comes
        # from config["enhancer_profile"] or color_profile.json (the
        # reference's profile file, frame_enhancer.py:46-54).
        use_enhancer = bool(config.get("use_enhancer", False))
        enhancer_profile = None
        if use_enhancer:
            enhancer_profile = config.get("enhancer_profile")
            if enhancer_profile is None:
                from chessboard_vision.utils.config import COLOR_PROFILE_FILE

                enhancer_profile = load_json_config(COLOR_PROFILE_FILE)
        self._pipeline_kwargs = dict(
            piece_settings=piece_settings,
            change_settings=change_settings,
            with_enhancer=use_enhancer,
            enhancer_profile=enhancer_profile,
        )
        self.pipeline = VisionPipeline(geometry, **self._pipeline_kwargs)
        self.pipe_state = self.pipeline.init_state()
        self.game = GameState()
        self.noise = NoiseHandler()
        self.status = self.STATE_IDLE
        # "auto_recalibrate": true — periodic drift check + self-healing
        # re-calibration (session/drift.py; beyond reference scope, which
        # only offers the manual 'c' re-reference).
        self.drift = None
        self.drift_check_interval = int(config.get("drift_check_interval", 300))
        if config.get("auto_recalibrate", False):
            from chessboard_vision.session.drift import DriftMonitor

            self.drift = DriftMonitor(
                np.asarray(config["corners"], np.float64).reshape(4, 2),
                threshold_px=float(config.get("drift_threshold_px", 4.0)),
                max_px=float(config.get("drift_max_px", 80.0)),
                confirm=int(config.get("drift_confirm_checks", 2)),
            )

    def capture_reference(self, cap, warmup: int = 10):
        """Capture the initial visual reference (reference game_session.py:93)."""
        for _ in range(warmup):
            cap.read()
        ok, img = cap.read()
        if ok:
            self.capture_reference_frame(img)

    def capture_reference_frame(self, img: np.ndarray):
        self.pipe_state = self.pipeline.capture_reference(self.pipe_state, img)
        self.status = self.STATE_IDLE
        if self.drift is not None:
            # Seed the drift baseline from the calibration-time frame, so a
            # bump before the first periodic check is still caught.
            self.drift.check(img)
        self.log.info("reference captured; game ready")

    # -- per-frame hot path ----------------------------------------------

    def _smart_scan_set(self):
        """Occupied squares + legal-move destinations (game_session.py:130-154)."""
        squares = set()
        with self.board_lock:
            squares.update(self.game.get_board_occupancy())
            for move in self.game.board.legal_moves:
                f = chess.square_file(move.to_square)
                r = chess.square_rank(move.to_square)
                if self.compat_visual_rank_quirk:
                    squares.add((f, 7 - r))
                else:
                    squares.add((f, r))
        return squares

    def on_frame(self, img: np.ndarray):
        """Process one camera frame (the main event)."""
        self.frame_count += 1
        self.fps.update()

        squares_to_check = None
        if self.frame_count % self.FULL_SCAN_PERIOD != 0 and self.game is not None:
            squares_to_check = self._smart_scan_set()

        refresh = self._refresh_next
        self._refresh_next = False
        self.pipe_state, out = self.pipeline.step(
            self.pipe_state, img, squares_to_check=squares_to_check, refresh_refs=refresh
        )
        self.last_outputs = out
        vision_occupied = occupancy_to_set(out.occupancy)
        visual_changes = occupancy_to_set(out.visual_changes)

        noise_state, noise_data = self.noise.process(visual_changes)
        self.status = (
            self.STATE_WAITING if noise_state == NoiseState.NOISE_ACTIVE else self.STATE_PROCESSING
        )

        self._update_radar_ui(vision_occupied)
        self._track_radii(vision_occupied, out)
        move = self._process_stable_move(vision_occupied, noise_state)

        # Periodic calibration-drift check (auto_recalibrate config key),
        # off the hot path (every drift_check_interval frames). NOT gated
        # on the noise FSM: a real bump keeps the FSM permanently
        # NOISE_ACTIVE (the shifted content never settles), which would
        # deadlock the very check that heals it; hand occlusion is handled
        # by the monitor's own gates (board-not-found / unstable
        # detections never confirm — session/drift.py).
        if (
            self.drift is not None
            and self.frame_count % self.drift_check_interval == 0
        ):
            new_corners = self.drift.check(img)
            if new_corners is not None:
                self._recalibrate(new_corners, img)

        if not self.headless:
            self._draw_interface(img, noise_state)
        return move

    # -- stability + inference -------------------------------------------

    def _process_stable_move(self, vision_occupied, noise_state):
        with self.board_lock:
            expected = self.game.get_board_occupancy()
            diff_missing = expected - vision_occupied
            diff_extra = vision_occupied - expected
            total_diff = len(diff_missing) + len(diff_extra)

            if total_diff > 4:  # too much change: probable hand/noise
                self.stable_count = 0
                self.stable_occupancy = set()
            elif self.stable_occupancy == vision_occupied:
                self.stable_count += 1
            else:
                self.stable_occupancy = set(vision_occupied)
                self.stable_count = 1

            now = time.time()
            if self.cooldown_frames is not None:
                cooldown_ok = (
                    self.frame_count - self.last_move_frame
                ) > self.cooldown_frames
            else:
                cooldown_ok = (now - self.last_move_time) > self.MOVE_COOLDOWN
            if (
                self.stable_count >= self.STABILITY_REQUIRED
                and cooldown_ok
                and noise_state != NoiseState.NOISE_ACTIVE
            ):
                move = self._infer_move(diff_missing, diff_extra, vision_occupied)
                if move:
                    self.log.info("robust move detected: %s", move.uci())
                    # Hook may block on network; lock intentionally held so
                    # the stream thread can't mutate the board meanwhile
                    # (reference game_session.py:211-213).
                    if self.on_move_detected(move):
                        if move in self.game.board.legal_moves:
                            self.game.board.push(move)
                            self.last_move_time = now
                            self.last_move_frame = self.frame_count
                            self._refresh_references()
                            self.noise.reset()
                            self.stable_count = 0
                            return move
                        self.log.critical(
                            "move %s became illegal before push", move.uci()
                        )
        return None

    def _recalibrate(self, corners: np.ndarray, frame: np.ndarray):
        """Rebuild geometry + pipeline around shifted corners, mid-game.

        Unlike configure(), the GAME is preserved: only the vision side is
        rebuilt (new resample plans from the new homography — plan arrays
        are jit arguments, so unchanged grid structure reuses the compiled
        step), visual references are re-captured from the current frame,
        and the stability/noise gates reset so no phantom move commits
        across the recalibration boundary. Smart-grid refinement lines are
        kept: they live in warped-board space, which the new homography
        still maps the same physical board onto."""
        with self.board_lock:
            self.config["corners"] = np.rint(np.asarray(corners)).astype(int).tolist()
            geometry = geo.BoardGeometry.from_config(self.config)
            self.pipeline = VisionPipeline(geometry, **self._pipeline_kwargs)
            self.pipe_state = self.pipeline.init_state()
            self.pipe_state = self.pipeline.capture_reference(self.pipe_state, frame)
            self.noise.reset()
            self.stable_count = 0
            self.stable_occupancy = None
            self._radius_window.clear()
            self._extent_window.clear()
            self._refresh_next = False
            self.log.warning("auto-recalibrated to shifted corners; game preserved")

    def _refresh_references(self):
        """Schedule a forced visual re-reference after a committed move
        (reference game_session.py:221: update_references + cache clear).
        Applied inside the next frame's device step with that frame's
        content — see VisionPipeline.step(refresh_refs=True)."""
        self._refresh_next = True

    def _infer_move(self, diff_missing, diff_extra, vision_occupied):
        """Infer one legal move from occupancy diffs (game_session.py:227-265).

        Shared with MultiStreamSession — see session/inference.py for the
        castling-first fix the reference's pair matching lacks."""
        return infer_move_from_diff(
            self.game, diff_missing, diff_extra, vision_occupied, log=self.log
        )

    def on_move_detected(self, move) -> bool:
        """Subclass hook; True accepts the move locally."""
        return True

    # -- piece-type classification (full FEN from vision) ----------------

    def _track_radii(self, vision_occupied, out):
        """Accumulate per-square (radius, extent) features from frames that
        agree with the rules board (the stability window the type
        classifier needs — see rules.piece_types.average_radii). Radii are
        masked by cascade method first: center_diff/symmetry squares carry
        only the min_dim//3 fallback, not a measured circle — their size
        comes from the ring-coverage extent instead. Once per position, a
        full window also refreshes the classifier's centroids with
        rules-labeled samples: the radius readout carries a per-square
        neighborhood bias, so the model must keep learning from isolated
        placements, not just the dense initial setup."""
        from chessboard_vision.rules.piece_types import mask_radii_by_method

        with self.board_lock:
            expected = self.game.get_board_occupancy()
        if expected != self._radius_window_occ:
            self._radius_window.clear()
            self._extent_window.clear()
            self._radius_window_occ = set(expected)
            self._types_updated_here = False
        if vision_occupied == expected:
            self._radius_window.append(
                mask_radii_by_method(out.radius, out.method)
            )
            self._extent_window.append(np.asarray(out.profile_extent))
        if (
            self.piece_types is not None
            and not getattr(self, "_types_updated_here", False)
            and len(self._radius_window) == self._radius_window.maxlen
        ):
            from chessboard_vision.rules.piece_types import (
                average_extents,
                average_radii,
            )

            with self.board_lock:
                self.piece_types.update(
                    average_radii(np.stack(self._radius_window)),
                    self.game.board,
                    extents=average_extents(np.stack(self._extent_window)),
                )
            self._types_updated_here = True

    def calibrate_piece_types(self):
        """Fit the piece-type radius model on the CURRENT (known) position.

        Call while the rules board matches the physical board and vision
        has settled — typically right after capture_reference at the
        initial setup, where all 12 (color, type) classes are visible.
        Returns the centroid dict, or None when no stable frames have
        accumulated yet."""
        if not self._radius_window:
            return None
        from chessboard_vision.rules.piece_types import (
            PieceTypeClassifier,
            average_extents,
            average_radii,
        )

        clf = PieceTypeClassifier()
        with self.board_lock:
            clf.calibrate(
                average_radii(np.stack(self._radius_window)),
                self.game.board,
                extents=average_extents(np.stack(self._extent_window)),
            )
        self.piece_types = clf
        return clf.centroids

    def full_fen(self):
        """Vision-side FULL FEN placement (piece types from the radius
        model), independent of game-state tracking. None until
        calibrate_piece_types has run and stable frames exist."""
        if (
            self.piece_types is None
            or self.last_outputs is None
            or not self._radius_window
        ):
            return None
        from chessboard_vision.rules import classify_piece_colors
        from chessboard_vision.rules.piece_types import (
            average_extents,
            average_radii,
            occupancy_to_full_fen,
        )

        out = self.last_outputs
        occ = np.asarray(out.occupancy)
        colors = classify_piece_colors(
            np.asarray(out.center_mean), occ, np.asarray(out.corner_mean)
        )
        chars = self.piece_types.classify(
            average_radii(np.stack(self._radius_window)), occ, colors,
            extents=average_extents(np.stack(self._extent_window)),
        )
        return occupancy_to_full_fen(occ.reshape(8, 8).T, chars, piece_colors=colors)

    def verify_position(self):
        """Cross-check the vision full-FEN readout against the rules board
        (the working version of the reference's broken board_verifiers
        sketch, at piece-TYPE granularity). Returns (match, got, want) —
        (None, None, want) when the classifier is not ready."""
        with self.board_lock:
            want = self.game.get_fen().split()[0]
        got = self.full_fen()
        if got is None:
            return None, None, want
        got = got.split()[0]
        return got == want, got, want

    # -- UI ---------------------------------------------------------------

    def _update_radar_ui(self, vision_occupied):
        # board_lock: legal-move generation mutates the shared board via
        # make/unmake, racing the Lichess stream thread's _sync_moves
        # (every other board reader here takes the lock too).
        with self.board_lock:
            expected = self.game.get_board_occupancy()
            lifted = expected - vision_occupied
            self.lifted_piece_square = None
            self.current_radar_destinations = []
            if len(lifted) == 1:
                pos = next(iter(lifted))
                sq = chess.square(pos[0], pos[1])
                piece = self.game.board.piece_at(sq)
                if piece and piece.color == self.game.board.turn:
                    self.lifted_piece_square = pos
                    for move in self.game.board.legal_moves:
                        if move.from_square == sq:
                            self.current_radar_destinations.append(
                                (chess.square_file(move.to_square), chess.square_rank(move.to_square))
                            )

    def _draw_interface(self, img_raw, noise_state):
        """cv2 overlay rendering (host-side; optional)."""
        import cv2

        from chessboard_vision.session.renderer import draw_board_overlay

        vis = self.pipeline.warp_board(img_raw)
        draw_board_overlay(
            vis,
            board_size=self.pipeline.geometry.board_size,
            grid_x=self.pipeline.geometry.grid_x,
            grid_y=self.pipeline.geometry.grid_y,
            game=self.game,
            board_lock=self.board_lock,
            noise_active=noise_state == NoiseState.NOISE_ACTIVE,
            lifted=self.lifted_piece_square,
            radar=self.current_radar_destinations,
            fps=self.fps.fps,
            clock_text=self.clock_hud(),
        )
        cv2.imshow("Board", vis)
        cv2.imshow("Camera", img_raw)

    # -- checkpoint / resume ---------------------------------------------

    def save_checkpoint(self, path: str):
        """Snapshot the full session mid-game: pipeline device state
        (visual references, EMA background model, detection history) +
        host state (board FEN, noise FSM, stability gate, config).

        The reference could only resume board geometry from JSON and the
        game from the Lichess server (SURVEY.md §5); this resumes the
        whole session locally without re-calibrating or re-referencing.
        """
        from chessboard_vision.utils.checkpoint import save_tree

        with self.board_lock:
            meta = {
                "fen": self.game.get_fen(),
                "config": self.config,
                "frame_count": self.frame_count,
                "stable_count": self.stable_count,
                "stable_occupancy": (
                    sorted(self.stable_occupancy)
                    if self.stable_occupancy is not None
                    else None
                ),
                "noise": {
                    "state": self.noise.state.name,
                    "stable_count": self.noise.stable_count,
                    "cooldown_count": self.noise.cooldown_count,
                    "pending_squares": sorted(self.noise.pending_squares),
                    "last_lifted_square": self.noise.last_lifted_square,
                },
            }
            save_tree(path, self.pipe_state, meta)
        self.log.info("checkpoint saved: %s", path)

    def resume_checkpoint(self, path: str):
        """Restore a save_checkpoint snapshot. Rebuilds the pipeline from
        the stored config when this session is not configured yet."""
        from chessboard_vision.utils.checkpoint import load_tree
        from chessboard_vision.session.noise import NoiseState

        # Peek the meta first when we still need the config to build the
        # pipeline (the tree template requires a configured pipeline).
        if self.pipeline is None:
            import json as _json

            with np.load(path) as data:
                cfg = _json.loads(
                    bytes(data["__meta__"].tobytes()).decode("utf-8")
                )["config"]
            self.configure(cfg)
        with self.board_lock:
            self.pipe_state, meta = load_tree(path, self.pipeline.init_state())
            self.game.set_fen(meta["fen"])
            self.frame_count = meta["frame_count"]
            self.stable_count = meta["stable_count"]
            self.stable_occupancy = (
                set(map(tuple, meta["stable_occupancy"]))
                if meta["stable_occupancy"] is not None
                else None
            )
            n = meta["noise"]
            self.noise.state = NoiseState[n["state"]]
            self.noise.stable_count = n["stable_count"]
            self.noise.cooldown_count = n["cooldown_count"]
            self.noise.pending_squares = set(map(tuple, n["pending_squares"]))
            self.noise.last_lifted_square = (
                tuple(n["last_lifted_square"])
                if n["last_lifted_square"] is not None
                else None
            )
            self.status = self.STATE_IDLE
        self.log.info("checkpoint resumed: %s (FEN %s)", path, meta["fen"])
        return meta

    def to_pgn(self, headers=None, comments=None, result=None,
               claim_draws=False) -> str:
        """The digitized game as a PGN document (rules/pgn.py) — the
        portable record the reference never produced. ``result`` overrides
        the position-derived termination (a subclass that KNOWS the
        outcome — e.g. LichessSession from the server status — passes it);
        ``claim_draws`` adjudicates a final claimable-draw position as
        1/2-1/2 (only set when the move list is the whole game)."""
        from chessboard_vision.rules.pgn import game_to_pgn

        with self.board_lock:
            moves = [m.uci() for m in self.game.board.move_stack]
            tags = {"White": "?", "Black": "?"}
            if self.player_color:
                tags[self.player_color.capitalize()] = "chessboard_vision"
            if headers:
                tags.update(headers)
            # Checkpoint resumes and Lichess from-position games replay
            # move_stack from a set_fen position, not the standard start.
            from chessboard_vision.rules.chesslib import STARTING_FEN

            start = self.game.start_fen
            return game_to_pgn(
                moves, headers=tags,
                start_fen=None if start == STARTING_FEN else start,
                result=result, comments=comments, claim_draws=claim_draws,
            )

    def clock_hud(self) -> str:
        """Clock HUD line; sessions with a clock source override this."""
        return ""

    def on_exit(self):
        pass
