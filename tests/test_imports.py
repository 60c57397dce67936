"""The vision session imports without the optional host packages."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_game_session_imports_without_requests_or_cv2():
    # requests (the Lichess client) and cv2 (the parity oracle and the
    # calibration UI) are not needed to run the vision path: GameSession
    # and VisionPipeline import with both blocked.
    code = (
        "import sys\n"
        "sys.modules['requests'] = None\n"
        "sys.modules['cv2'] = None\n"
        "from chessboard_vision.session.game_session import GameSession\n"
        "from chessboard_vision.models.pipeline import VisionPipeline\n"
        "import chessboard_vision.session as s\n"
        "assert 'chessboard_vision.net.lichess_client' not in sys.modules\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr
