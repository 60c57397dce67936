"""Parallel layer: multi-stream batching, device-mesh sharding, and the
multi-host (multi-process) fleet bootstrap."""

from chessboard_vision.parallel.mesh import make_mesh, stream_sharding
from chessboard_vision.parallel.multistream import MultiStreamPipeline
from chessboard_vision.parallel.distributed import (
    init_distributed,
    global_stream_mesh,
    distribute_local_streams,
)

__all__ = [
    "make_mesh",
    "stream_sharding",
    "MultiStreamPipeline",
    "init_distributed",
    "global_stream_mesh",
    "distribute_local_streams",
]
