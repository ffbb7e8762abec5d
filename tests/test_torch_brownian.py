"""The port's Brownian tree (rsvldm_tpu_torch/diffusion/brownian.py) held
against the JAX package's: from the same key, nothing injected, W(t)
equals JAX's brownian_point within 1e-6 relative (its end point and node
normals are JAX's, drawn by utils/prng.py), and so does the sampler call;
then the properties JAX's tests pin (tests/test_brownian.py): exact
increment additivity, query-order freedom, W(t0) = 0, N(0, dt)
increments that are uncorrelated, the sampler call's sign convention and
path consistency across grids."""

import jax
import numpy as np
import pytest
import torch

from rsvldm_tpu.diffusion.brownian import BrownianTreeNoiseSampler as JTree
from rsvldm_tpu.diffusion.brownian import brownian_point as j_point
from rsvldm_tpu_torch.diffusion.brownian import (BrownianTreeNoiseSampler,
                                                 brownian_point)
from rsvldm_tpu_torch.utils import prng

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(7)
PKEY = prng.key(7)
SHAPE = (4096,)
T0, T1 = 0.03, 14.6


@pytest.mark.parametrize("t", [T0, 0.5, 1.0, 3.7, 7.31, 12.0, T1, 20.0, 0.0])
def test_point_equals_jax_with_its_draws(t):
    got = brownian_point(PKEY, t, T0, T1, (64,)).numpy()
    want = np.asarray(j_point(KEY, t, T0, T1, (64,)))
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= 1e-6


def test_sampler_call_equals_jax_with_its_draws():
    tree = BrownianTreeNoiseSampler(T0, T1, (2, 4, 4, 3), PKEY, "cpu")
    jtree = JTree(KEY, T0, T1, (2, 4, 4, 3))
    for a, b in ((9.0, 4.0), (4.0, 9.0), (14.6, 0.03), (2.2, 2.25)):
        np.testing.assert_allclose(tree(a, b).numpy(), np.asarray(jtree(a, b)),
                                   rtol=1e-5, atol=1e-5)


def w(t, seed=7, shape=SHAPE):
    return brownian_point(prng.key(seed), t, T0, T1, shape).numpy()


def test_deterministic_and_query_order_free():
    a1 = w(3.7)
    _ = w(11.0), w(0.5)
    np.testing.assert_array_equal(a1, w(3.7))
    assert np.all(w(T0) == 0.0)
    assert np.isfinite(w(T1)).all()
    # another seed is another path
    assert not np.allclose(w(3.7), w(3.7, seed=8))


def test_increment_additivity():
    wa, wb, wc = w(1.0), w(5.0), w(12.0)
    np.testing.assert_allclose(wc - wa, (wb - wa) + (wc - wb), atol=1e-6)


def test_marginals_and_independence():
    ts = np.linspace(T0, T1, 9)
    pts = [w(t) for t in ts]
    incs = [(pts[i + 1] - pts[i]) / np.sqrt(ts[i + 1] - ts[i])
            for i in range(8)]
    for inc in incs:
        assert abs(inc.mean()) < 0.08
        assert abs(inc.std() - 1.0) < 0.08
    for i in range(7):
        assert abs(np.corrcoef(incs[i], incs[i + 1])[0, 1]) < 0.08


@pytest.mark.parametrize("t", [0.5, 7.31])
def test_point_draws_are_jax_end_and_node_normals(t, monkeypatch):
    """A point is one draw of depth + 1 rows: JAX's normals of k_end, then
    of fold_in(fold_in(k_tree, level), index) along the path to t."""
    seen = []
    draw = prng.draw
    monkeypatch.setattr(prng, "draw", lambda rows, *a, **k: seen.append(
        (rows, draw(rows, *a, **k))) or seen[-1][1])
    brownian_point(PKEY, t, T0, T1, (64, 64), depth=6)
    (rows, z), = seen
    assert len(rows) == 7
    k_end, k_tree = jax.random.split(KEY)
    want = [jax.random.normal(k_end, (64, 64))]
    idx, a, b = 0, np.float32(T0), np.float32(T1)
    for level in range(6):
        want.append(jax.random.normal(jax.random.fold_in(
            jax.random.fold_in(k_tree, level), idx), (64, 64)))
        m = np.float32(np.float32(0.5) * np.float32(a + b))
        right = np.float32(t) >= m
        a, b = (m, b) if right else (a, m)
        idx = 2 * idx + int(right)
    want = np.stack([np.asarray(w) for w in want])
    assert np.abs(z.numpy() - want).max() <= 1e-6 * max(1.0, np.abs(want).max())
    assert abs(z.numpy().mean()) < 0.05 and abs(z.numpy().std() - 1.0) < 0.05


def test_normalized_sampler_call():
    tree = BrownianTreeNoiseSampler(T0, T1, SHAPE, PKEY, "cpu")
    eps = tree(9.0, 4.0).numpy()
    assert abs(eps.std() - 1.0) < 0.08
    np.testing.assert_allclose(eps, -tree(4.0, 9.0).numpy(), rtol=1e-6)


def test_path_consistency_across_grids():
    tree = BrownianTreeNoiseSampler(T0, T1, SHAPE, PKEY, "cpu")
    coarse = (tree.w(10.0) - tree.w(2.0)).numpy()
    fine = sum((tree.w(a + 2.0) - tree.w(a)).numpy()
               for a in [2.0, 4.0, 6.0, 8.0])
    np.testing.assert_allclose(coarse, fine, atol=1e-4)
