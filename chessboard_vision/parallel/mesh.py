"""Device-mesh helpers for multi-chip scale-out.

The workload's parallel axes (SURVEY.md §2 parallelism accounting):
- "data": independent camera streams (pure data parallelism — zero
  cross-stream communication; collectives only appear if a reduction over
  streams is requested, e.g. fleet-wide metrics)
- "space": the 64-square axis inside each stream (spatial/model
  parallelism for the per-square perception kernels)

Shardings are expressed with jax.sharding.NamedSharding; XLA inserts any
needed collectives (over NVLink between the GPUs of one host). On one
device the same code runs with a 1-device mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a mesh over the first n_devices devices.

    Default: 1-D "data" mesh over all devices. Pass shape for multi-axis
    meshes, e.g. make_mesh(8, ("data", "space"), (4, 2)).
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(
            f"make_mesh: requested {n_devices} devices but only "
            f"{len(devices)} available on backend "
            f"'{jax.default_backend()}'. For a virtual CPU mesh, start the "
            "process with XLA_FLAGS=--xla_force_host_platform_device_count="
            f"{n_devices} and force the cpu platform "
            '(jax.config.update("jax_platforms", "cpu")) before jax '
            "initializes — see tests/conftest.py."
        )
    devices = devices[:n_devices]
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axes) - 1)
    mesh_devices = np.asarray(devices).reshape(shape)
    return Mesh(mesh_devices, axis_names=tuple(axes))


def stream_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Sharding for arrays whose leading axis is the stream/batch axis."""
    return NamedSharding(mesh, P(axis))


def stream_square_sharding(mesh: Mesh, data_axis="data", space_axis="space") -> NamedSharding:
    """Sharding for (streams, 64, ...) arrays over a 2-D mesh."""
    return NamedSharding(mesh, P(data_axis, space_axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_pytree_leading_axis(tree, mesh: Mesh, axis: str = "data"):
    """Place every array leaf with its leading axis sharded over ``axis``."""
    sh = stream_sharding(mesh, axis)
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)


def shard_pytree_stream_square(tree, mesh: Mesh, data_axis="data", space_axis="space"):
    """2-D placement: leading (stream) axis over ``data``; for leaves whose
    second axis is the 64-square axis, shard it over ``space`` too (spatial
    parallelism of the per-square perception work). Other leaves replicate
    their trailing dims."""
    two_d = NamedSharding(mesh, P(data_axis, space_axis))
    one_d = NamedSharding(mesh, P(data_axis))

    def place(x):
        if x.ndim >= 2 and x.shape[1] == 64 and 64 % mesh.shape[space_axis] == 0:
            return jax.device_put(x, two_d)
        return jax.device_put(x, one_d)

    return jax.tree.map(place, tree)
