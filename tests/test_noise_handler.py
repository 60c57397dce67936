"""NoiseHandler FSM tests (mirrors reference test_noise_handler.py coverage)."""

from chessboard_vision.session import NoiseHandler, NoiseState


class TestNoiseHandler:
    def test_idle_no_changes(self):
        h = NoiseHandler()
        state, data = h.process(set())
        assert state == NoiseState.IDLE
        assert data["message"] == "waiting"

    def test_single_change_goes_pending_with_lifted(self):
        h = NoiseHandler()
        state, data = h.process({(4, 1)})
        assert state == NoiseState.MOVE_PENDING
        assert data["lifted"] == (4, 1)
        assert data["stable"] is False

    def test_many_changes_goes_noise(self):
        h = NoiseHandler()
        state, data = h.process({(0, 0), (1, 1), (2, 2), (3, 3), (4, 4)})
        assert state == NoiseState.NOISE_ACTIVE
        assert data["message"] == "hand_detected"
        assert h.is_blocked()

    def test_stability_counter_to_stable_ready(self):
        h = NoiseHandler()
        squares = {(4, 1), (4, 3)}
        h.process(squares)
        for _ in range(NoiseHandler.STABILITY_FRAMES - 2):
            state, data = h.process(squares)
            assert data["stable"] is False
        state, data = h.process(squares)
        assert state == NoiseState.MOVE_PENDING
        assert data["message"] == "stable_ready"
        assert data["stable"] is True
        assert data["squares"] == squares

    def test_move_ready_after_changes_clear(self):
        h = NoiseHandler()
        squares = {(4, 1)}
        h.process(squares)  # stable_count = 1
        for _ in range(NoiseHandler.STABILITY_FRAMES - 2):
            state, data = h.process(set())
            assert state == NoiseState.MOVE_PENDING
        state, data = h.process(set())  # reaches STABILITY_FRAMES
        assert state == NoiseState.IDLE
        assert data["message"] == "move_ready"
        assert data["squares"] == squares

    def test_noise_cooldown_exit(self):
        h = NoiseHandler()
        h.process({(i, i) for i in range(6)})
        for _ in range(NoiseHandler.COOLDOWN_FRAMES - 1):
            state, _ = h.process(set())
            assert state == NoiseState.NOISE_ACTIVE
        state, data = h.process(set())
        assert state == NoiseState.IDLE
        assert data["message"] == "noise_cleared"

    def test_noise_interrupts_pending(self):
        h = NoiseHandler()
        h.process({(4, 1)})
        state, data = h.process({(i, i) for i in range(6)})
        assert state == NoiseState.NOISE_ACTIVE
        assert data["message"] == "interrupted_by_hand"

    def test_pending_squares_update_resets_counter(self):
        h = NoiseHandler()
        h.process({(4, 1)})
        h.process({(4, 1)})
        state, data = h.process({(5, 2)})
        assert state == NoiseState.MOVE_PENDING
        assert data["message"] == "updated"
        assert data["squares"] == {(5, 2)}
        assert h.stable_count == 1

    def test_reset_and_state_names(self):
        h = NoiseHandler()
        h.process({(i, 0) for i in range(5)})
        assert h.get_state_name() == "NOISE"
        h.reset()
        assert h.get_state_name() == "IDLE"
        assert not h.is_blocked()
