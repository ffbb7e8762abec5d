"""utils/prng.py against jax.random (JAX 0.9, partitionable threefry), on
the CPU through the plain version: keys, split, fold_in, bits and uniforms
bit-equal; normals and Gumbels within 1e-6 * max(1, |JAX|) (XLA's log1p and
log are its own polynomials, torch's are the C library's: they differ in
the last bit); categorical ids equal; a multi-row draw equal to the stacked
single-key draws; randint bit-equal (spans that are not powers of two,
maxval <= minval, the whole int32 range); the device-keyed draw_folded at
one, two and three fold words equal to nested jax.random.fold_in draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvldm_tpu_torch.utils import prng

JKEY = jax.random.PRNGKey(7)
KEY = prng.key(7)
N = (4099,)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _jkey(k) -> tuple:
    return tuple(int(v) for v in np.asarray(k))


def _close(got: torch.Tensor, want, tol: float = 1e-6):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, f"max scaled err {err.max()}"


def test_jax_layout_is_partitionable():
    """The port follows the partitionable layout: a change of JAX's
    default would change every draw."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_key(seed):
    assert prng.key(seed) == _jkey(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("n", [2, 4])
def test_split(n):
    assert prng.split(KEY, n) == [_jkey(k) for k in jax.random.split(JKEY, n)]


@pytest.mark.parametrize("data", [0, 1, 499, 2 ** 31 - 1])
def test_fold_in(data):
    assert prng.fold_in(KEY, data) == _jkey(jax.random.fold_in(JKEY, data))


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (2, 3, 4)])
def test_bits(shape):
    want = np.asarray(jax.random.bits(JKEY, shape)).astype(np.int64)
    got = prng.bits(KEY, shape).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for width, dt in ((8, jnp.uint8), (16, jnp.uint16)):
        np.testing.assert_array_equal(
            prng.bits(KEY, shape, width).numpy(),
            np.asarray(jax.random.bits(JKEY, shape, dt)).astype(np.int64))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.0, 2.5)])
def test_uniform(dt, lo, hi):
    jdt, tdt = DTYPES[dt]
    got = prng.uniform(KEY, N, tdt, lo, hi)
    assert got.dtype == tdt
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(jax.random.uniform(JKEY, N, jdt, lo, hi).astype(jnp.float32)))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_normal(dt):
    jdt, tdt = DTYPES[dt]
    got = prng.normal(KEY, N, tdt)
    assert got.dtype == tdt
    _close(got, jax.random.normal(JKEY, N, jdt))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_gumbel(dt):
    jdt, tdt = DTYPES[dt]
    _close(prng.gumbel(KEY, N, tdt), jax.random.gumbel(JKEY, N, jdt))


def test_categorical():
    logits = np.random.default_rng(0).standard_normal((2, 1000)).astype(np.float32)
    for seed in range(5):
        want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed),
                                                 jnp.asarray(logits)))
        got = prng.categorical(prng.key(seed), torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dist", ["bits", "normal", "gumbel"])
def test_multi_row_draw_equals_single_draws(dist):
    """One draw of rows (key, step): row r is the draw of fold_in(key, step),
    or of the key itself where step is None, as JAX's loops fold step keys."""
    other = prng.split(KEY)[1]
    rows = [(other, None), (KEY, 3), (KEY, 0), (other, 2 ** 31 - 1)]
    dtype = torch.int64 if dist == "bits" else torch.float32
    got = prng.draw(rows, (3, 5), dist, dtype)
    assert got.shape == (4, 3, 5)
    single = {"bits": lambda k: prng.bits(k, (3, 5)),
              "normal": lambda k: prng.normal(k, (3, 5)),
              "gumbel": lambda k: prng.gumbel(k, (3, 5))}[dist]
    for r, (k, s) in enumerate(rows):
        torch.testing.assert_close(got[r], single(prng.row_key(k, s)),
                                   rtol=0, atol=0)
    jfn = {"bits": lambda k: jax.random.bits(k, (3, 5)),
           "normal": lambda k: jax.random.normal(k, (3, 5)),
           "gumbel": lambda k: jax.random.gumbel(k, (3, 5))}[dist]
    jother = jax.random.split(JKEY)[1]
    want = np.stack([np.asarray(jfn(jother)), np.asarray(jfn(jax.random.fold_in(JKEY, 3))),
                     np.asarray(jfn(jax.random.fold_in(JKEY, 0))),
                     np.asarray(jfn(jax.random.fold_in(jother, 2 ** 31 - 1)))])
    if dist == "bits":
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    else:
        _close(got, want)


def test_plain_draw_in_chunks_is_one_draw(monkeypatch):
    """A plain draw over more rows than one chunk holds gives the rows a
    one-chunk draw gives."""
    rows = [(KEY, i) for i in range(5)]
    whole = prng.draw(rows, (4, 3), "normal")
    monkeypatch.setattr(prng, "PLAIN_CHUNK", 12)
    torch.testing.assert_close(prng.draw(rows, (4, 3), "normal"), whole,
                               rtol=0, atol=0)


def test_draw_into_out_and_rejects_bad_dists():
    out = torch.empty((2, 6))
    res = prng.draw([(KEY, None), (KEY, 1)], (6,), "gumbel", out=out)
    assert res is out
    torch.testing.assert_close(out[1], prng.gumbel(prng.fold_in(KEY, 1), (6,)),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown distribution"):
        prng.draw([(KEY, None)], (2,), "laplace")
    with pytest.raises(TypeError, match="bits draws take"):
        prng.draw([(KEY, None)], (2,), "bits", torch.float32)


def test_cuda_draw_takes_no_plain_path():
    """A draw asked on the card launches the kernel or raises: on a machine
    without one it raises rather than computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py holds the kernel")
    launches = prng.draw.launches
    with pytest.raises((RuntimeError, AssertionError)):
        prng.draw([(KEY, None)], (8,), "normal", device="cuda")
    assert prng.draw.launches == launches


@pytest.mark.parametrize("lo,hi", [(0, 10), (1, 2001), (0, 1000), (-100, 37),
                                   (3, 1 << 16), (5, 5), (7, 3),
                                   (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)])
def test_randint(lo, hi):
    for shape in ((), (513,), (3, 7)):
        want = np.asarray(jax.random.randint(JKEY, shape, lo, hi))
        got = prng.randint(KEY, shape, lo, hi)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _nested(words) -> jax.Array:
    k = JKEY
    for w in words:
        k = jax.random.fold_in(k, w)
    return k


@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("dist", ["bits", "uniform", "normal", "gumbel"])
def test_draw_folded_equals_nested_fold_in(L, dist):
    """Row r of draw_folded is the draw of fold_in(...fold_in(key, w[r, 0])
    ..., w[r, L-1]); its plain version equals draw_folded on the CPU."""
    words = torch.tensor([[3, 5, 7], [0, 1, 13], [2 ** 31 - 1, 7, 0],
                          [9, 2 ** 32 - 1, 7]])[:, :L]
    dtype = torch.int64 if dist == "bits" else torch.float32
    got = prng.draw_folded(KEY, words, (3, 5), dist, dtype)
    assert got.shape == (4, 3, 5)
    torch.testing.assert_close(
        prng.draw_folded_plain(KEY, words, (3, 5), dist, dtype), got,
        rtol=0, atol=0)
    jfn = {"bits": lambda k: jax.random.bits(k, (3, 5)),
           "uniform": lambda k: jax.random.uniform(k, (3, 5)),
           "normal": lambda k: jax.random.normal(k, (3, 5)),
           "gumbel": lambda k: jax.random.gumbel(k, (3, 5))}[dist]
    want = np.stack([np.asarray(jfn(_nested(w))) for w in words.tolist()])
    if dist in ("bits", "uniform"):
        np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype))
    else:
        _close(got, want)


def test_draw_folded_scalar_rows_and_bf16():
    """shape () gives one draw a row (the acceptance uniforms); bf16 rows
    as JAX's bf16 draws."""
    words = torch.tensor([[1, 2, 7], [4, 4, 7], [6, 0, 7]])
    got = prng.draw_folded(KEY, words, (), "uniform")
    assert got.shape == (3,)
    want = [np.asarray(jax.random.uniform(_nested(w))) for w in words.tolist()]
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    g16 = prng.draw_folded(KEY, words[:, :2], (129,), "gumbel", torch.bfloat16)
    _close(g16, np.stack([np.asarray(jax.random.gumbel(_nested(w), (129,),
                                                       jnp.bfloat16))
                          for w in words[:, :2].tolist()]))
    with pytest.raises(ValueError, match="folds"):
        prng.draw_folded(KEY, torch.zeros((2, 4), dtype=torch.int64), (2,))


def test_cuda_draw_folded_takes_no_plain_path():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py holds the kernel")
    launches = prng.draw_folded.launches
    with pytest.raises((RuntimeError, AssertionError)):
        prng.draw_folded(KEY, torch.zeros((2, 2), dtype=torch.int64,
                                          device="cuda"), (8,), "normal")
    assert prng.draw_folded.launches == launches
