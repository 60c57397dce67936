"""Worker for tests/test_distributed.py: one process of a 2-process CPU
fleet. Validates the multi-host mesh design end-to-end on this machine:
distributed init (Gloo collectives), global "data" mesh, per-process
stream contribution via distribute_local_streams, a sharded jit with a
cross-process reduction, host-locality of addressable shards, and — when
given an expected-occupancy file (argv[3]) — a REAL MultiStreamPipeline
tick (warp -> detect -> change model -> FSM) over the global mesh with
per-process frames, asserting this host's occupancy shards bit-match the
single-process reference run.
"""

import os
import sys

pid = int(sys.argv[1])
port = sys.argv[2]
expected_path = sys.argv[3] if len(sys.argv) > 3 else None

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["CBV_COORDINATOR"] = f"localhost:{port}"
os.environ["CBV_NUM_PROCESSES"] = "2"
os.environ["CBV_PROCESS_ID"] = str(pid)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from chessboard_vision.parallel.distributed import (  # noqa: E402
    distribute_local_streams,
    global_stream_mesh,
    init_distributed,
)
from chessboard_vision.parallel.mesh import replicated, stream_sharding  # noqa: E402

assert init_distributed(), "distributed init failed"
assert jax.process_count() == 2 and jax.device_count() == 8

mesh = global_stream_mesh()
assert mesh.devices.shape == (8,)

# Each host contributes 4 streams of tiny (3, 8, 8) frames carrying its
# process id; the fleet batch is (8, 3, 8, 8) sharded over "data".
local = np.full((4, 3, 8, 8), pid, np.float32)
g = distribute_local_streams(mesh, local)
assert g.shape == (8, 3, 8, 8)

# Host-locality: this process's addressable shards hold exactly its own
# streams (stream frames never cross DCN).
for shard in g.addressable_shards:
    np.testing.assert_array_equal(np.asarray(shard.data), pid)

# A per-stream map + fleet-level reduction (the only cross-DCN traffic).
per_stream = jax.jit(
    lambda x: x.mean(axis=(1, 2, 3)),
    out_shardings=stream_sharding(mesh),
)(g)
fleet_total = jax.jit(
    lambda x: x.sum(),
    out_shardings=replicated(mesh),
)(per_stream)
assert float(fleet_total) == 4.0, float(fleet_total)  # 4 streams of 1s

# --- the real pipeline across the fleet (round-3 verdict item 4) --------
if expected_path is not None:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fleet_fixture import (  # noqa: E402
        N_STREAMS,
        STREAMS_PER_PROC,
        make_fleet_pipeline,
        stream_frames,
    )

    ms = make_fleet_pipeline(mesh)
    state = ms.init_state()
    local_gis = list(range(pid * STREAMS_PER_PROC, (pid + 1) * STREAMS_PER_PROC))
    refs = np.stack([stream_frames(gi)[0] for gi in local_gis])
    steps = np.stack([stream_frames(gi)[1] for gi in local_gis])

    # Each host contributes only its own rigs' frames; _place assembles
    # them with jax.make_array_from_process_local_data.
    state = ms.capture_reference(state, refs)
    state, out = ms.step(state, steps)

    occ = out.step.occupancy  # global (N_STREAMS, 64), sharded over "data"
    assert occ.shape == (N_STREAMS, 64)
    expected = np.load(expected_path)["occ"]
    seen = set()
    for shard in occ.addressable_shards:
        lo = shard.index[0].start or 0
        hi = shard.index[0].stop or N_STREAMS
        for gi in range(lo, hi):
            seen.add(gi)
        np.testing.assert_array_equal(
            np.asarray(shard.data), expected[lo:hi],
            err_msg=f"occupancy mismatch for streams {lo}:{hi}",
        )
    # Host-locality: this process's occupancy shards are exactly its rigs'.
    assert seen == set(local_gis), (sorted(seen), local_gis)
    print(f"VISION-OK proc={pid}", flush=True)

print(f"OK proc={pid}", flush=True)
