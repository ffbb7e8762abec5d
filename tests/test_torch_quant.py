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
    x, w = _x_w(7, 1, 256, 32)
    ql = tq.quantize_weight_int4(torch.from_numpy(w))
    xq, xs = tq.quantize_acts_grouped(torch.from_numpy(x), 128)
    with pytest.raises(ValueError, match="CUDA"):
        tq._k2(xq.reshape(1, 256), xs.reshape(1, 2), ql)


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
