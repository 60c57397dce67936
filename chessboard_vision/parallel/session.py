"""MultiStreamSession: N concurrent game sessions on one batched pipeline.

The deployment shape the BASELINE north-star names: N camera rigs digitized
by a single device program per tick. The vision work (warp, detection,
change model, noise FSM) runs batched and sharded on device
(parallel/multistream.py); this wrapper keeps N independent host-side rule
states (move inference, stability gating, per-stream callbacks) and feeds
smart-scan masks back per stream.

Per-stream semantics match GameSession (same stability constants and
inference); the noise FSM runs on device (ops/fsm.py — differentially
identical to the host FSM).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import jax
import numpy as np

from chessboard_vision.geometry import BoardGeometry
from chessboard_vision.models.pipeline import occupancy_to_set, positions_to_mask
from chessboard_vision.parallel.multistream import MultiStreamPipeline
from chessboard_vision.rules import chess, GameState
from chessboard_vision.session.inference import infer_move_from_diff
from chessboard_vision.utils.logging import get_logger


class _StreamState:
    def __init__(self):
        self.game = GameState()
        self.stable_occupancy = None
        self.stable_count = 0
        self.last_move_time = 0.0
        self.refresh_next = False


class MultiStreamSession:
    STABILITY_REQUIRED = 20
    MOVE_COOLDOWN = 2.0
    FULL_SCAN_PERIOD = 30

    def __init__(
        self,
        geometry: BoardGeometry,
        n_streams: int,
        mesh=None,
        on_move_detected: Optional[Callable[[int, "chess.Move"], bool]] = None,
        auto_recalibrate: bool = False,
        drift_check_interval: int = 300,
        drift_threshold_px: float = 4.0,
        drift_max_px: float = 80.0,
        drift_confirm: int = 2,
        **pipeline_kw,
    ):
        self.n = n_streams
        if isinstance(geometry, (list, tuple)):
            self.geometries = list(geometry)
        else:
            self.geometries = [geometry] * n_streams
        self._mesh = mesh
        # Honor the tuned settings files by default, exactly like the
        # single-stream GameSession.configure does (otherwise tuned
        # sensitivity silently reverts to defaults in multi-stream
        # sessions). Explicit kwargs still win.
        from chessboard_vision.utils.config import (
            PIECE_SETTINGS_FILE,
            SENSITIVITY_FILE,
            load_json_config,
        )

        pipeline_kw.setdefault(
            "piece_settings", load_json_config(PIECE_SETTINGS_FILE)
        )
        pipeline_kw.setdefault(
            "change_settings", load_json_config(SENSITIVITY_FILE)
        )
        self._pipeline_kw = dict(pipeline_kw)
        self.ms = MultiStreamPipeline(geometry, n_streams=n_streams, mesh=mesh, **pipeline_kw)
        self.state = self.ms.init_state()
        self.streams = [_StreamState() for _ in range(n_streams)]
        self.frame_count = 0
        self.on_move_detected = on_move_detected or (lambda i, m: True)
        self.log = get_logger("msession")
        # Per-rig drift monitors (auto-recalibration — session/drift.py).
        # A confirmed camera bump on any rig rebuilds the batched pipeline
        # with that rig's shifted geometry (per-stream-geometry mode), all
        # game states preserved.
        self.drift_check_interval = int(drift_check_interval)
        self.drift = None
        if auto_recalibrate:
            from chessboard_vision.session.drift import DriftMonitor

            self.drift = [
                DriftMonitor(
                    g.src_corners,
                    threshold_px=drift_threshold_px,
                    max_px=drift_max_px,
                    confirm=drift_confirm,
                )
                for g in self.geometries
            ]

    def capture_reference(self, frames):
        self.state = self.ms.capture_reference(self.state, frames)
        if self.drift is not None:
            for mon, frame in zip(self.drift, self._hwc_frames(frames)):
                mon.check(frame)  # seed each rig's detection baseline

    @staticmethod
    def _hwc_frames(frames) -> np.ndarray:
        """(N, H, W, 3) host frames for the cv2-based drift detector,
        from either the HWC or planar (N, 3, H, W) layout."""
        arr = np.asarray(frames)
        if arr.ndim == 4 and arr.shape[1] == 3 and arr.shape[-1] != 3:
            arr = np.moveaxis(arr, 1, -1)
        return arr

    def _check_drift(self, frames):
        hwc = self._hwc_frames(frames)
        confirmed = []
        for i, mon in enumerate(self.drift):
            new_corners = mon.check(hwc[i])
            if new_corners is not None:
                confirmed.append(i)
                self.geometries[i] = self.geometries[i].with_corners(
                    np.rint(new_corners)  # reorder() truncates float input
                )
        if not confirmed:
            return
        self.log.warning(
            "streams %s auto-recalibrating to shifted corners", confirmed
        )
        # ONE rebuild for however many rigs confirmed this tick (a shared-
        # mount bump shifts all of them at once), in per-stream-geometry
        # mode — shared grid structure, so resample-plan static dims are
        # unchanged. Only the BUMPED rigs' device state is replaced (their
        # frame passed the drift gates); the other rigs keep their current
        # visual references and temporal state untouched — re-capturing
        # them from unvetted live frames could bake a hand or a mid-move
        # transient into their background model.
        self.ms = MultiStreamPipeline(
            self.geometries, n_streams=self.n, mesh=self._mesh,
            **self._pipeline_kw,
        )
        fresh = self.ms.capture_reference(self.ms.init_state(), frames)
        idx = np.asarray(confirmed)
        self.state = jax.tree.map(
            lambda old, new: old.at[idx].set(new[idx]), self.state, fresh
        )
        for i in confirmed:
            st = self.streams[i]
            st.stable_count = 0
            st.stable_occupancy = None
            st.refresh_next = False

    def _smart_scan_mask(self, st: _StreamState) -> np.ndarray:
        squares = set(st.game.get_board_occupancy())
        for move in st.game.board.legal_moves:
            squares.add((chess.square_file(move.to_square), chess.square_rank(move.to_square)))
        return positions_to_mask(squares)

    def on_frames(self, frames) -> List[Optional["chess.Move"]]:
        """One tick: (N, 3, H, W) frames -> committed move (or None) per stream."""
        self.frame_count += 1
        if self.frame_count % self.FULL_SCAN_PERIOD != 0:
            s2c = np.stack([self._smart_scan_mask(st) for st in self.streams])
        else:
            s2c = None
        refresh = np.array([st.refresh_next for st in self.streams])
        for st in self.streams:
            st.refresh_next = False

        if (
            self.drift is not None
            and self.frame_count % self.drift_check_interval == 0
        ):
            self._check_drift(frames)

        self.state, out = self.ms.step(self.state, frames, s2c_masks=s2c, refresh=refresh)

        occ = np.asarray(out.step.occupancy)
        blocked = np.asarray(out.noise.blocked)
        moves: List[Optional[chess.Move]] = []
        now = time.time()
        for i, st in enumerate(self.streams):
            vision = occupancy_to_set(occ[i])
            moves.append(self._process_stable_move(i, st, vision, bool(blocked[i]), now))
        return moves

    def _process_stable_move(self, idx, st: _StreamState, vision, blocked, now):
        expected = st.game.get_board_occupancy()
        missing = expected - vision
        extra = vision - expected
        if len(missing) + len(extra) > 4:
            st.stable_count = 0
            st.stable_occupancy = set()
        elif st.stable_occupancy == vision:
            st.stable_count += 1
        else:
            st.stable_occupancy = set(vision)
            st.stable_count = 1

        if (
            st.stable_count >= self.STABILITY_REQUIRED
            and (now - st.last_move_time) > self.MOVE_COOLDOWN
            and not blocked
        ):
            move = self._infer_move(st, missing, extra, vision)
            if move and self.on_move_detected(idx, move):
                if move in st.game.board.legal_moves:
                    st.game.board.push(move)
                    st.last_move_time = now
                    st.refresh_next = True
                    st.stable_count = 0
                    self.log.info("stream %d: committed %s", idx, move.uci())
                    return move
        return None

    def _infer_move(self, st, missing, extra, vision):
        # Shared with GameSession (castling-first, pair-match, capture
        # scan) — see session/inference.py.
        return infer_move_from_diff(st.game, missing, extra, vision, log=self.log)

    def to_pgn(self, stream: int, headers=None, claim_draws=False) -> str:
        """PGN document for one stream's digitized game (rules/pgn.py)."""
        from chessboard_vision.rules.chesslib import STARTING_FEN
        from chessboard_vision.rules.pgn import game_to_pgn

        st = self.streams[stream]
        start = st.game.start_fen
        return game_to_pgn(
            [m.uci() for m in st.game.board.move_stack],
            headers=headers,
            start_fen=None if start == STARTING_FEN else start,
            claim_draws=claim_draws,
        )

    # -- checkpoint / resume ----------------------------------------------

    def save_checkpoint(self, path: str):
        """Snapshot all N games mid-play: the batched device state (visual
        references, EMA models, detection history, device noise FSM — one
        pytree with leading (N,) axes) plus per-stream host rule state.
        The GameSession equivalent is session/game_session.save_checkpoint;
        this is its batched twin."""
        from chessboard_vision.utils.checkpoint import save_tree

        meta = {
            "n": self.n,
            "frame_count": self.frame_count,
            "streams": [
                {
                    "fen": st.game.get_fen(),
                    "stable_count": st.stable_count,
                    "stable_occupancy": (
                        sorted(st.stable_occupancy)
                        if st.stable_occupancy is not None
                        else None
                    ),
                    "refresh_next": st.refresh_next,
                }
                for st in self.streams
            ],
            "corners": [
                None if g.src_corners is None else np.asarray(g.src_corners).tolist()
                for g in self.geometries
            ],
        }
        save_tree(path, self.state, meta)
        self.log.info("multi-stream checkpoint saved: %s", path)

    def resume_checkpoint(self, path: str) -> dict:
        """Restore a save_checkpoint snapshot into this (already
        constructed, same-geometry) session: device pytree + every
        stream's game/stability state. Returns the checkpoint meta."""
        import json as _json

        from chessboard_vision.utils.checkpoint import load_tree

        with np.load(path) as data:  # peek n before shaping the template
            n_ckpt = _json.loads(
                bytes(data["__meta__"].tobytes()).decode("utf-8")
            )["n"]
        if n_ckpt != self.n:
            raise ValueError(
                f"checkpoint has {n_ckpt} streams; this session has {self.n}"
            )
        state, meta = load_tree(path, self.ms.init_state())
        # Restore per-rig geometries recorded at save time: an
        # auto-recalibrated session's corners differ from the original
        # calibration this session was constructed with, and the loaded
        # visual references were captured under the SAVED geometry —
        # pairing them with old-corner resample plans would pass the shape
        # check but silently break detection on the drifted rigs.
        saved = [
            None if c is None else np.asarray(c, np.float64)
            for c in meta.get("corners", [None] * self.n)
        ]
        changed = [
            i for i, c in enumerate(saved)
            if c is not None
            and self.geometries[i].src_corners is not None
            and not np.allclose(c, self.geometries[i].src_corners)
        ]
        if changed:
            self.log.warning(
                "checkpoint geometry differs on streams %s; rebuilding",
                changed,
            )
            for i in changed:
                self.geometries[i] = self.geometries[i].with_corners(
                    np.rint(saved[i])
                )
            self.ms = MultiStreamPipeline(
                self.geometries, n_streams=self.n, mesh=self._mesh,
                **self._pipeline_kw,
            )
        if self.drift is not None:
            from chessboard_vision.session.drift import DriftMonitor

            self.drift = [
                DriftMonitor(
                    g.src_corners,
                    threshold_px=mon.threshold_px,
                    max_px=mon.max_px,
                    confirm=mon.confirm,
                )
                for g, mon in zip(self.geometries, self.drift)
            ]
        self.state = state
        self.frame_count = meta["frame_count"]
        for st, m in zip(self.streams, meta["streams"]):
            st.game.set_fen(m["fen"])
            st.stable_count = m["stable_count"]
            st.stable_occupancy = (
                set(map(tuple, m["stable_occupancy"]))
                if m["stable_occupancy"] is not None
                else None
            )
            st.refresh_next = m["refresh_next"]
            st.last_move_time = 0.0
        self.log.info("multi-stream checkpoint resumed: %s", path)
        return meta
