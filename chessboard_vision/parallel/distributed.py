"""Multi-host (multi-process) mesh bootstrap.

The single-process path (parallel/mesh.py) covers one host's devices; this
module extends the same mesh/sharding design to a multi-host fleet —
N camera rigs feeding several hosts, streams sharded over the global
"data" axis so each host's streams land on its locally-attached devices
(stream frames never cross the host network; only fleet-level reductions
do).

Design notes (scaling-book recipe):
- jax.distributed.initialize() wires the processes. GPU hosts need the
  coordinator address, process count and process id (arguments or the
  CBV_* environment variables below); clusters whose scheduler JAX
  recognizes supply them itself.
- The global mesh uses jax.devices() (all processes' devices). Axis
  order ("data", "space") keeps the stream axis outermost so the
  contiguous device blocks of each host serve that host's streams —
  cross-host traffic carries only optional fleet reductions, per-stream
  compute stays on each host's own devices.
- Per-process arrays are assembled into global arrays with
  jax.make_array_from_process_local_data (each host contributes its own
  streams' frames; no host ever materializes the fleet's full batch).

The reference app has no distributed layer at all (SURVEY.md §2:
"no NCCL/MPI/Gloo/UCX — single-process CV app"); this is the scale-out
story for fleets of boards.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax

from chessboard_vision.parallel.mesh import make_mesh, stream_sharding
from chessboard_vision.utils.logging import get_logger

log = get_logger("distributed")

_initialized = False


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the JAX distributed runtime (idempotent).

    With no arguments: environments JAX's cluster detection recognizes
    supply everything.
    Explicit arguments (or CBV_COORDINATOR / CBV_NUM_PROCESSES /
    CBV_PROCESS_ID env vars) cover manual bring-up, e.g. CPU fleets in
    tests. Returns True when the runtime is up (or already was), False
    when initialization is unavailable in this environment — callers then
    continue single-process (1-host mesh), which is always valid.
    """
    global _initialized
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get("CBV_COORDINATOR")
    if num_processes is None and "CBV_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["CBV_NUM_PROCESSES"])
    if process_id is None and "CBV_PROCESS_ID" in os.environ:
        process_id = int(os.environ["CBV_PROCESS_ID"])
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _initialized = True
        log.info(
            "distributed runtime up: process %d/%d, %d local / %d global devices",
            jax.process_index(), jax.process_count(),
            jax.local_device_count(), jax.device_count(),
        )
        return True
    except (ValueError, RuntimeError) as e:
        log.warning("distributed init unavailable (%s); running single-process", e)
        return False


def global_stream_mesh(axes: Sequence[str] = ("data",)):
    """Mesh over ALL processes' devices, stream axis outermost.

    jax.devices() orders devices process-major, so a 1-D "data" mesh
    gives each host a contiguous block — its own streams stay on its own
    devices and the host network carries only optional fleet-level
    collectives.
    """
    return make_mesh(jax.device_count(), axes)


def distribute_local_streams(mesh, local_frames):
    """Assemble each process's (local_streams, ...) frame batch into one
    global (total_streams, ...) array sharded over the "data" axis.

    Each host contributes only its own rigs' frames; no host materializes
    the fleet batch.
    """
    sharding = stream_sharding(mesh)
    global_shape = (
        local_frames.shape[0] * jax.process_count(),
    ) + local_frames.shape[1:]
    return jax.make_array_from_process_local_data(
        sharding, local_frames, global_shape
    )
