"""Kernel parity on the card (``gpu`` marker): skips where JAX finds no GPU.

Run on a machine with an NVIDIA GPU:
    CBV_TEST_GPU=1 python -m pytest tests/test_card.py -m gpu -q
chip_smoke.py runs the same checks (CARD_CHECKS) in its last phase.
"""

import numpy as np
import pytest

import card_checks as cc

_rng = np.random.default_rng(5)

CARD_CHECKS = [
    (cc.check_bilateral, ((3, 720, 1280),)),
    (cc.check_bilateral, ((3, 620, 620),)),
    (cc.check_bilateral, ((3, 77, 77),)),
    (cc.check_clahe, ((620, 620),)),
    (cc.check_clahe, ((720, 1280),)),
    (cc.check_clahe, ((77, 77),)),
    (cc.check_score_matmul, (_rng.standard_normal((512, 384)), _rng.standard_normal((64, 384)))),
    (cc.check_score_matmul, (_rng.standard_normal((512, 384)), _rng.standard_normal((4, 64, 384)), 4)),
]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "check,args", CARD_CHECKS,
    ids=[f"{fn.__name__}-{i}" for i, (fn, _) in enumerate(CARD_CHECKS)],
)
def test_card_check(gpu, check, args):
    check(*args)
