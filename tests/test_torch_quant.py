"""The port's int8 / int4 quantizers and products held against the JAX
package's (rsvldm_tpu/ops/quant.py) on the CPU, fp32, inputs made with numpy
from a seed. Quantized bytes and scales must be identical; the products
differ only in the order of fp32 sums over groups."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvldm_tpu.ops import quant as jq
from rsvldm_tpu_torch.ops import quant as tq

torch.set_num_threads(1)


def _x_w(seed, rows, inf, out, wscale=0.05):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, inf)).astype(np.float32),
            (rng.normal(size=(inf, out)) * wscale).astype(np.float32))


def test_quantize_weight_int8_bytes_equal():
    _, w = _x_w(0, 1, 96, 40)
    want = jq.quantize_weight(jnp.asarray(w))
    got = tq.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("inf,out,group", [(256, 48, 128), (64, 24, 128),
                                           (512, 384, 128), (96, 16, 32)])
def test_quantize_weight_int4_bytes_equal(inf, out, group):
    _, w = _x_w(1, 1, inf, out)
    want = jq.quantize_weight_int4(jnp.asarray(w), group=group)
    got = tq.quantize_weight_int4(torch.from_numpy(w), group=group)
    assert got.packed.dtype == torch.int8
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(tq.unpack_int4(got.packed).numpy(),
                                  np.asarray(jq.unpack_int4(want.packed)))


def test_quantize_acts_grouped_equal():
    x, _ = _x_w(2, 5, 256, 1)
    wq, ws = jq.quantize_acts_grouped(jnp.asarray(x), 128)
    gq, gs = tq.quantize_acts_grouped(torch.from_numpy(x), 128)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("rows", [1, 7])
def test_int8_matmul_matches_jax(rows):
    x, w = _x_w(3, rows, 160, 72)
    ql = jq.quantize_weight(jnp.asarray(w))
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), ql, out_dtype=jnp.float32))
    got = tq.int8_matmul(torch.from_numpy(x),
                         tq.QuantizedLinear(torch.tensor(np.asarray(ql.q)),
                                            torch.tensor(np.asarray(ql.scale))),
                         out_dtype=torch.float32)
    # the int32 products are exact on both sides; the same two fp32 scale
    # multiplies follow: equal to the last bit
    np.testing.assert_array_equal(got.numpy(), want)


def _port_int4(ql):
    return tq.Int4Linear(torch.tensor(np.asarray(ql.packed)),
                         torch.tensor(np.asarray(ql.scale)))


@pytest.mark.parametrize("shape,inf,out,group", [((3,), 512, 384, 128),
                                                 ((2, 5), 256, 64, 128),
                                                 ((4,), 64, 32, 32)])
def test_int4_matmul_grouped_matches_xla(shape, inf, out, group):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(*shape, inf)).astype(np.float32)
    w = (rng.normal(size=(inf, out)) * 0.05).astype(np.float32)
    ql = jq.quantize_weight_int4(jnp.asarray(w), group=group)
    want = np.asarray(jax.jit(jq._int4_matmul_xla, static_argnums=2)(
        jnp.asarray(x), ql, jnp.float32))
    got = tq.int4_matmul_grouped(torch.from_numpy(x), _port_int4(ql),
                                 out_dtype=torch.float32).numpy()
    assert got.shape == want.shape
    # exact group sums on both sides; only the fp32 sum over groups differs
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows", [1, 2, 9, 32])
def test_int4_ref_matches_pallas_kernel(rows):
    """K2's plain version against the Pallas kernel in interpret mode, at
    the JAX test's shapes and bar (tests/test_quant.py:211-240): out=384 is
    not a multiple of the kernel's column tile."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(rows, 512)).astype(np.float32)
    w = (rng.normal(size=(512, 384)) * 0.05).astype(np.float32)
    ql = jq.quantize_weight_int4(jnp.asarray(w), group=128)
    want = np.asarray(jq.int4_matmul_pallas(jnp.asarray(x), ql,
                                            out_dtype=jnp.float32,
                                            interpret=True))
    got = tq.int4_matmul_ref(torch.from_numpy(x), _port_int4(ql)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)


def test_int4_dispatch_on_cpu_takes_the_plain_path():
    x, w = _x_w(5, 2, 256, 128)
    ql = tq.quantize_weight_int4(torch.from_numpy(w))
    before = tq.int4_matmul.launches
    got = tq.int4_matmul(torch.from_numpy(x), ql, out_dtype=torch.float32)
    assert tq.int4_matmul.launches == before
    torch.testing.assert_close(got, tq.int4_matmul_ref(torch.from_numpy(x), ql),
                               rtol=0, atol=0)


def test_int4_ref_refuses_what_k2_does_not_take():
    _, w = _x_w(6, 1, 64, 16)
    ql = tq.quantize_weight_int4(torch.from_numpy(w), group=32)
    with pytest.raises(ValueError, match="group 128"):
        tq.int4_matmul_ref(torch.zeros(1, 64), ql)


def test_k2_refuses_cpu_tensors():
    """_k2 takes x itself (it quantizes inside the kernel) and launches or
    raises: a CPU tensor is refused, not computed."""
    x, w = _x_w(7, 1, 256, 32)
    ql = tq.quantize_weight_int4(torch.from_numpy(w))
    before = tq.int4_matmul.launches
    with pytest.raises(ValueError, match="CUDA"):
        tq._k2(torch.from_numpy(x).to(torch.bfloat16), ql)
    with pytest.raises(ValueError, match="CUDA"):
        tq._k2(torch.from_numpy(x), ql, torch.float32)
    assert tq.int4_matmul.launches == before


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the 8 bytes y:x."""
    src = [(x >> (8 * k)) & 0xFF for k in range(4)] + \
          [(y >> (8 * k)) & 0xFF for k in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _dp4a(a, b):
    s8 = lambda v, k: ((v >> (8 * k)) & 0xFF) - (((v >> (8 * k)) & 0x80) << 1)
    return sum(s8(a, k) * s8(b, k) for k in range(4))


def test_k2_nibble_algebra_exhaustive():
    """K2's word-level unpack over every packed byte and every int8 code:
    (b & 0x0F) * x - 8 * x and (b & 0xF0, signed) * x / 16 equal the
    unpacked low and high weights times x."""
    b = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(torch.int8)
    lo, hi = tq.unpack_int4(b[None, :]).to(torch.int64)  # the two planes
    x = torch.arange(-127, 128, dtype=torch.int64)[:, None]
    bu = b.to(torch.int64) & 0xFF
    lo_b = bu & 0x0F
    hi16 = (bu & 0xF0) - ((bu & 0x80) << 1)              # as a signed byte
    assert torch.equal(lo_b * x - 8 * x, lo * x)
    assert torch.equal(hi16 * x, 16 * hi * x)
    assert torch.equal((hi16 * x) >> 4, hi * x)          # exact: a multiple of 16


def test_k2_transpose_and_dp4a_give_group_sums():
    """The kernel's 4x4 byte transpose (__byte_perm selectors 0x5140,
    0x7362, then 0x5410, 0x7632) and masked dp4a over 4 packed rows give
    each column's exact sums of both planes."""
    rng = np.random.default_rng(12)
    for _ in range(50):
        rows = rng.integers(0, 256, (4, 4))              # [row, column] bytes
        w = [int(sum(int(rows[k, c]) << (8 * c) for c in range(4)))
             for k in range(4)]
        xl, xh = rng.integers(-127, 128, 4), rng.integers(-127, 128, 4)
        pack = lambda v: int(sum((int(v[k]) & 0xFF) << (8 * k) for k in range(4)))
        a, b = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[0], w[1], 0x7362)
        e, f = _byte_perm(w[2], w[3], 0x5140), _byte_perm(w[2], w[3], 0x7362)
        t = [_byte_perm(a, e, 0x5410), _byte_perm(a, e, 0x7632),
             _byte_perm(b, f, 0x5410), _byte_perm(b, f, 0x7632)]
        q = tq.unpack_int4(torch.tensor(rows, dtype=torch.uint8).view(torch.int8))
        q = q.to(torch.int64).numpy()                    # [8, 4]: low, high
        for c in range(4):
            assert _dp4a(t[c] & 0x0F0F0F0F, pack(xl)) - 8 * int(xl.sum()) \
                == int((q[:4, c] * xl).sum())
            assert _dp4a(t[c] & 0xF0F0F0F0, pack(xh)) >> 4 \
                == int((q[4:, c] * xh).sum())


def _ties_of_reciprocal(n):
    """fp32 values a (bf16-exact, as decode activations are) where a * (1 /
    127) != a / 127 in fp32, as CUDA's division by a Python number gives."""
    a = (np.arange(1, 1 << 15, dtype=np.uint32) << 16).view(np.float32)
    a = a[np.isfinite(a) & (a > 1e-3) & (a < 1e3)]
    bad = a[(a * np.float32(1 / 127)) != (a / np.float32(127))]
    return bad[np.linspace(0, len(bad) - 1, n).astype(int)]


@pytest.mark.parametrize("grouped", [False, True])
def test_quantize_acts_bit_equal_to_jax(grouped):
    """Codes and scales of both activation quantizers equal JAX's bit for
    bit, for rows whose amax is where a reciprocal multiply would differ,
    and for an all-zero row / group (scale clamped to 1e-12, codes 0)."""
    amax = _ties_of_reciprocal(6)
    assert len(amax) == 6
    rng = np.random.default_rng(13)
    x = rng.uniform(-1, 1, (6, 256)).astype(np.float32) * amax[:, None]
    x[np.arange(6), rng.integers(0, 256, 6)] = amax
    x[2] = 0.0
    x[4, 128:] = 0.0
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    if grouped:
        wq, ws = jq.quantize_acts_grouped(jnp.asarray(x), 128)
        gq, gs = tq.quantize_acts_grouped(torch.from_numpy(x), 128)
    else:
        wq, ws = jq.quantize_acts(jnp.asarray(x))
        gq, gs = tq.quantize_acts(torch.from_numpy(x))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy().view(np.uint32),
                                  np.asarray(ws).view(np.uint32))
    assert (gq.numpy()[2] == 0).all()
    assert gs.numpy().reshape(6, -1)[2, 0] == np.float32(1e-12)


# one Llama-3-8B decode step's shapes (R = 1), more rows, ragged ones,
# 19 pairs (no split count divides them) and the most pairs K2 takes
K2_SHAPES = [(1, 4096, 4096), (1, 4096, 1024), (1, 4096, 14336),
             (1, 14336, 4096), (1, 4096, 128256), (8, 4096, 4096),
             (32, 4096, 4096), (1, 4096, 4144), (3, 512, 1000), (2, 512, 64),
             (1, 4864, 4096), (8, 4864, 1024), (1, 65536, 64),
             (32, 32768, 64)]


def _k2_blocks(plan, r, inf, out):
    """Each block of K2's grid as (rows, columns, pairs) ranges, by the
    kernel's index arithmetic (csrc/int4_decode.cu: blockIdx.x a column
    tile, .y a split of the pairs, .z a chunk of rows)."""
    npairs = inf // 256
    for z in range(-(-r // plan.rb)):
        for s in range(plan.splits):
            p0 = npairs * s // plan.splits
            p1 = npairs * (s + 1) // plan.splits
            for t in range(-(-out // plan.tn)):
                yield (range(z * plan.rb, min(r, (z + 1) * plan.rb)),
                       range(t * plan.tn, min(out, (t + 1) * plan.tn)),
                       range(p0, p1))


@pytest.mark.parametrize("r,inf,out", K2_SHAPES)
def test_k2_plan_covers_every_output_once(r, inf, out):
    """K2's grid covers every (row, column, group pair) exactly once, with
    at most 16 pairs a block, and the decode shapes get at least 132
    blocks."""
    plan = tq.k2_plan(r, inf, out)
    assert plan.tn in (64, 128, 256) and plan.rb in (1, 2, 4)
    assert plan.splits <= (16 if plan.rb == 1 else 8)  # one cluster
    hits = np.zeros((r, out, inf // 256), np.int32)
    blocks = list(_k2_blocks(plan, r, inf, out))
    for rows, cols, pairs in blocks:
        assert 1 <= len(pairs) <= tq.K2_MAX_PAIRS and len(rows) >= 1
        hits[rows.start:rows.stop, cols.start:cols.stop,
             pairs.start:pairs.stop] += 1
    assert (hits == 1).all()
    if r == 1 and out % 1024 == 0 and inf >= 4096:
        assert len(blocks) >= 132


@pytest.mark.parametrize("r,inf", [(1, 65536 + 256), (2, 32768 + 256),
                                   (32, 32768 + 256)])
def test_k2_plan_none_past_its_pairs(r, inf):
    """Past 16 pairs a block in the largest cluster K2 has no plan, and
    int4_matmul takes the grouped path there (on the card as on the CPU)."""
    assert tq.k2_plan(r, inf, 4096) is None
    assert tq.k2_plan(r, inf - 256, 4096) is not None


def test_quantized_weights_are_contiguous_from_a_transposed_view():
    """Linear weights are [out, in]; the quantizers get their [in, out]
    transposed view and must still return row-major tensors (K2 and the
    int8 GEMM read them so)."""
    _, w = _x_w(8, 1, 256, 64)
    view = torch.from_numpy(np.ascontiguousarray(w.T)).t()
    for ql in (tq.quantize_weight_int4(view), tq.quantize_weight(view)):
        assert all(t.is_contiguous() for t in ql)
    np.testing.assert_array_equal(tq.quantize_weight_int4(view).packed.numpy(),
                                  tq.quantize_weight_int4(torch.from_numpy(w)).packed.numpy())
