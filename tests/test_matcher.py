"""Matcher against NumPy float64 `D1 @ D2.T` (findMaxCorr semantics,
surfd.cu:2610-2669): best score, first-index argmax, second best over
the other columns, invalid set-2 columns never chosen."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_surf_tpu.ops.matcher import match

NEG = -1e30


def _unit(rng, n, d):
    x = rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _reference(d1, d2, v2):
    """float64 best / second / first-index argmax over valid columns."""
    s = d1.astype(np.float64) @ d2.astype(np.float64).T
    s = np.where(v2[None, :], s, -np.inf)
    idx = np.argmax(s, axis=1)
    best = s[np.arange(len(d1)), idx]
    s2 = s.copy()
    s2[np.arange(len(d1)), idx] = -np.inf
    second = s2.max(axis=1) if d2.shape[0] > 1 else np.full(len(d1), -np.inf)
    return best, second, idx


_CASES = {
    "ragged_small": (5, 7, 64, None),
    "ragged_tiles": (300, 1500, 64, None),
    "one_row": (1, 33, 64, None),
    "extended_128": (200, 260, 128, None),
    "invalid_block": (64, 96, 64, slice(10, 50)),
    "exact_ties": (40, 80, 64, "ties"),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_match_matches_float64(case):
    n1, n2, d, special = _CASES[case]
    rng = np.random.default_rng(n1 * 7 + n2)
    d1 = _unit(rng, n1, d)
    d2 = _unit(rng, n2, d)
    v2 = np.ones(n2, bool)
    if isinstance(special, slice):
        v2[special] = False
        d2[special] = d1[: special.stop - special.start]  # best if valid
    elif special == "ties":
        # duplicated columns: the first index must win, and the second
        # best equals the best
        d2[n2 // 2] = d1[3]
        d2[n2 - 1] = d1[3]
        d2[5] = d1[9]
        d2[6] = d1[9]
    m = jax.jit(match)(jnp.asarray(d1), jnp.ones(n1, bool), jnp.asarray(d2),
                       jnp.asarray(v2), jnp.arange(n2, dtype=jnp.float32),
                       jnp.zeros(n2, jnp.float32))
    best, second, idx = _reference(d1, d2, v2)
    score = np.asarray(m.score)
    np.testing.assert_allclose(score, best, atol=1e-5)
    gap = best - second
    sure = gap > 1e-5
    np.testing.assert_array_equal(np.asarray(m.index)[sure], idx[sure])
    assert v2[np.asarray(m.index)].all()
    np.testing.assert_array_equal(np.asarray(m.match_x),
                                  np.asarray(m.index).astype(np.float32))
    amb = np.where(np.isfinite(second), second / (best + 1e-6), 0.0)
    np.testing.assert_allclose(np.asarray(m.ambiguity), amb, atol=1e-5)
    if special == "ties":
        assert int(m.index[3]) == n2 // 2 and int(m.index[9]) == 5
        np.testing.assert_allclose(np.asarray(m.ambiguity)[[3, 9]],
                                   1.0 / (1 + 1e-6), atol=1e-6)


def test_match_all_columns_invalid():
    rng = np.random.default_rng(3)
    d1, d2 = _unit(rng, 6, 64), _unit(rng, 9, 64)
    m = match(jnp.asarray(d1), jnp.ones(6, bool), jnp.asarray(d2),
              jnp.zeros(9, bool), jnp.zeros(9), jnp.zeros(9))
    assert not np.asarray(m.valid).any()
    assert (np.asarray(m.ambiguity) == 0).all()
