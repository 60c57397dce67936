"""minDist tie-order fidelity study (ROADMAP round-3 item).

cv2.HoughCircles sorts center candidates by accumulator value and
suppresses within minDist in that order; its tie order on EQUAL
accumulator values is implementation-defined (std::sort on the nonmax-
suppressed candidate list). The exact backend (ops/hough.py) picks
argmax per scan step — a potentially different tie order. This study
quantifies whether that ever matters for the app's decision
(found + center-within-30%-window):

- ties at the top accumulator value do occur (vote plateaus at a circle
  center), but the tied cells are CLUSTERED: any order yields the same
  decision because every tied cell maps into (or out of) the center
  window together, and cells within minDist of each other suppress to a
  single survivor anyway;
- decision-relevant ties — tied top cells farther apart than the center
  window — are asserted to be ~absent on realistic square populations.

Conclusion: decision-level parity is the right bar;
pinning cv2's exact tie order would chase an implementation detail cv2
itself does not guarantee across versions.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from chessboard_vision.ops import hough as hough_ops
from chessboard_vision.ops.canny import canny
from chessboard_vision.ops.filters import sobel3

from fixtures import make_square

SIZE = 77  # the reference's square size at 620px boards
DP = 1.2
PARAM1, PARAM2 = 100, 25


def _tie_stats(imgs):
    """(n_ties, n_decision_relevant, n_squares_with_candidates)."""
    h = np.full(64, SIZE)
    p, b = hough_ops.HoughParams.from_geometry(h, h)
    gray = jnp.asarray(imgs)
    edges = canny(gray, PARAM1 // 2, PARAM1)
    dx, dy = sobel3(gray, border="reflect101")
    acc = hough_ops._vote(edges, dx, dy, p, b, DP)
    cand = np.asarray(hough_ops._center_candidates(acc, p, PARAM2))
    aw = cand.shape[2]
    flat = cand.reshape(64, -1)
    top = flat.max(-1)
    center_window = 0.3 * SIZE
    n_tie = n_rel = n_cand = 0
    for sq in range(64):
        if top[sq] <= PARAM2:
            continue
        n_cand += 1
        tied = np.nonzero(flat[sq] == top[sq])[0]
        if len(tied) < 2:
            continue
        n_tie += 1
        # full-res centers of the tied accumulator cells
        cy = (tied // aw + 0.5) * DP
        cx = (tied % aw + 0.5) * DP
        c0 = SIZE // 2
        # decision-relevant iff tie order can flip the within-window
        # verdict: some tied cell inside the center window, some outside
        inside = np.hypot(cx - c0, cy - c0) <= center_window
        if inside.any() and not inside.all():
            n_rel += 1
    return n_tie, n_rel, n_cand


def test_tie_order_is_decision_irrelevant(rng):
    pops = []
    # clean centered circles (the easy case: strong single peak)
    pops.append([make_square(rng, radius=int(rng.integers(18, 40)), contrast=90,
                             noise=3, size=SIZE) for _ in range(64)])
    # weak off-center circles near the param2 margin (tie-prone)
    pops.append([make_square(rng, radius=int(rng.integers(16, 42)),
                             contrast=int(rng.integers(25, 50)),
                             noise=int(rng.integers(6, 14)),
                             off=(int(rng.integers(-9, 10)), int(rng.integers(-9, 10))),
                             size=SIZE) for _ in range(64)])
    # textured flats (spurious candidates, if any)
    pops.append([make_square(rng, radius=None, noise=int(rng.integers(8, 16)),
                             size=SIZE) for _ in range(64)])

    tot_tie = tot_rel = tot_cand = 0
    for imgs in pops:
        t, r, c = _tie_stats(np.stack(imgs))
        tot_tie += t
        tot_rel += r
        tot_cand += c
    print(f"squares with candidates: {tot_cand}; top-value ties: {tot_tie}; "
          f"decision-relevant ties: {tot_rel}")
    assert tot_cand > 100  # the study actually exercised detections
    # tie order must not be able to flip the app's decision
    assert tot_rel == 0, (
        f"{tot_rel} squares have tied top candidates straddling the "
        "center window — tie order would change decisions there"
    )
