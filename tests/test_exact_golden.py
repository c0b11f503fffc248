"""Bit-exact golden images.

The renderer is provably deterministic on a fixed platform
(test_golden.py's re-render test), so the CPU test platform can gate on
EXACT pixel arrays: np.array_equal, no tolerance. The r3 statistics
thresholds (e.g. img.max() > 5.0) would have passed a 30% global radiance
regression; these can't.

Goldens cover the repo scenes AND the reference's own two scenes
(/root/reference/scenes — its de-facto goldens,
examples/render_from_file.rs:5-12). Regenerate intentionally with
tools/make_goldens.py and commit the diff.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
GOLD = REPO / "tests" / "goldens"
sys.path.insert(0, str(REPO / "tools"))

from make_goldens import BASE, CASES, render_case  # noqa: E402


@pytest.mark.parametrize(
    "name,path,overrides", CASES, ids=[c[0] for c in CASES]
)
def test_exact_golden(name, path, overrides):
    if not path.exists():
        pytest.skip(f"{path} not available")
    gold_path = GOLD / f"{name}.npy"
    assert gold_path.exists(), (
        f"missing golden {gold_path}; run tools/make_goldens.py"
    )
    gold = np.load(gold_path)
    img = render_case(path, overrides)
    assert img.shape == gold.shape
    if not np.array_equal(img, gold):
        bad = np.nonzero(np.any(img != gold, axis=-1))
        n_bad = len(bad[0])
        worst = np.unravel_index(np.argmax(np.abs(img - gold)), img.shape)
        raise AssertionError(
            f"{name}: {n_bad}/{img.shape[0]*img.shape[1]} pixels differ from "
            f"golden (worst at {worst}: {img[worst[:2]]} vs {gold[worst[:2]]})."
            " If the image change is intentional, regenerate with"
            " tools/make_goldens.py and commit."
        )
