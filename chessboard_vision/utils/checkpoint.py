"""Session checkpointing: device-state pytrees + host metadata in one npz.

The reference's only resumable state is JSON configs plus the Lichess
server's move list (SURVEY.md §5 checkpoint/resume); this adds true
mid-game snapshots — the pipeline's device state (visual references, EMA
background model, detection history) and the session's host state — so a
crashed or intentionally stopped session resumes without re-calibrating
or re-referencing the board.

Format: np.savez_compressed with the pytree leaves in jax.tree order
(``leaf_<i>``) plus a JSON metadata blob (``__meta__``). Loading
unflattens against a template tree (e.g. ``pipeline.init_state()``), so
the format needs no pickled structure.
"""

from __future__ import annotations

import json
from typing import Any, Tuple

import numpy as np
import jax
import jax.numpy as jnp


def save_tree(path: str, tree: Any, meta: dict) -> None:
    """Save a pytree's leaves + a JSON-serializable metadata dict."""
    leaves = jax.tree.leaves(tree)
    arrays = {f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_tree(path: str, template: Any) -> Tuple[Any, dict]:
    """Load (tree, meta); tree structure/dtypes come from ``template``."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode("utf-8"))
        treedef = jax.tree.structure(template)
        t_leaves = jax.tree.leaves(template)
        leaves = []
        for i, tmpl in enumerate(t_leaves):
            arr = data[f"leaf_{i}"]
            want_shape = tuple(np.shape(tmpl))
            if arr.shape != want_shape:
                if arr.ndim == 0 and arr.dtype == np.bool_ == np.asarray(tmpl).dtype:
                    # Legacy-format leaf: a bool FLAG field later widened
                    # from scalar to vector (ChangeModelState.calibrated,
                    # () -> (64,)) broadcasts losslessly — old checkpoints
                    # stay resumable. Scoped to matching bool
                    # dtypes only: silently broadcasting an arbitrary
                    # scalar would mask genuinely incompatible checkpoints
                    # whose flattened leaf order shifted.
                    arr = np.broadcast_to(arr, want_shape).copy()
                elif (
                    arr.ndim == 3
                    and len(want_shape) == 2
                    and arr.shape[0] == want_shape[0]
                    and arr.shape[1] * arr.shape[2] == want_shape[1]
                ):
                    # Legacy-format leaf: the change model's means/
                    # variances moved from (64, H, W) to flat (64, H*W)
                    # (layout-unambiguity, ops/change.ChangeModelState).
                    # Row-major flatten is value-identical.
                    arr = arr.reshape(want_shape)
                else:
                    raise ValueError(
                        f"checkpoint leaf {i} shape {arr.shape} != template "
                        f"{want_shape} — was the pipeline built with a "
                        "different geometry?"
                    )
            # coerce to the template's dtype (as documented): a leaf
            # saved under a different dtype config would otherwise change
            # the jitted step's signature or fail deep inside the scan
            want = np.asarray(tmpl).dtype
            if arr.dtype != want:
                arr = arr.astype(want)
            leaves.append(jnp.asarray(arr))
    return jax.tree.unflatten(treedef, leaves), meta
