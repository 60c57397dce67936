"""Utilities: config persistence, env loading, logging, profiling."""

from chessboard_vision.utils.config import (
    load_json_config,
    save_json_config,
    load_dotenv,
    CALIBRATION_FILE,
    COLOR_PROFILE_FILE,
    PIECE_SETTINGS_FILE,
    SENSITIVITY_FILE,
)
from chessboard_vision.utils.logging import setup_logger, get_logger
from chessboard_vision.utils.profiling import FpsCounter, StageTimer

__all__ = [
    "load_json_config",
    "save_json_config",
    "load_dotenv",
    "CALIBRATION_FILE",
    "COLOR_PROFILE_FILE",
    "PIECE_SETTINGS_FILE",
    "SENSITIVITY_FILE",
    "setup_logger",
    "get_logger",
    "FpsCounter",
    "StageTimer",
]
