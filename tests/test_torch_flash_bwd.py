"""K3/K4's plain version and the port's autograd Function over K1, held
against the JAX package's fused Pallas backward (`flash_attention_bwd`,
interpret mode) and the VJP of its XLA attention, on the same numpy inputs;
fp32 on the CPU. Tolerance atol 2e-4, rtol 2e-3, as
tests/test_attention.py holds the Pallas backward to the XLA VJP (measured:
at most 2.4e-6 here, summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvldm_tpu.ops.attention import _xla_attention
from rsvldm_tpu.ops.flash_attention import flash_attention as jax_flash
from rsvldm_tpu.ops.flash_attention import flash_attention_bwd as jax_bwd
from rsvldm_tpu_torch.ops import attention as port_attn
from rsvldm_tpu_torch.ops.flash_attention import (flash_attention,
                                                  flash_attention_bwd,
                                                  flash_attention_bwd_ref)

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-3)


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    mk = lambda s: rng.standard_normal((b, s, h, d)).astype(np.float32)
    return mk(sq), mk(sk), mk(sk), mk(sq)


def _port_bwd(q, k, v, g, causal):
    t = [torch.from_numpy(x) for x in (q, k, v, g)]
    out, lse = flash_attention(*t[:3], causal=causal, return_lse=True)
    return flash_attention_bwd_ref(*t[:3], out, lse, t[3], causal=causal)


# tests/test_attention.py:151-157 and :197-201: causal and not, sq != sk,
# lengths off the block; D=16 as there and D=128 as the Llama heads
@pytest.mark.parametrize("sq,sk,causal,d", [
    (96, 96, False, 16), (96, 96, True, 16), (64, 160, True, 16),
    (90, 150, False, 16), (90, 150, True, 16),
    (192, 192, False, 16), (192, 192, True, 16), (200, 264, True, 16),
    (96, 96, True, 128), (90, 150, False, 128),
])
def test_bwd_ref_matches_pallas_and_xla_vjp(sq, sk, causal, d):
    q, k, v, g = _inputs(2, sq, sk, 2, d, sq * 7 + sk + d)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    out, lse = jax_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                         interpret=True, return_lse=True)
    want_pallas = jax_bwd(jq, jk, jv, out, lse, jg, causal=causal, block_q=64,
                          block_k=64, interpret=True)
    _, vjp = jax.vjp(lambda q, k, v: _xla_attention(q, k, v, causal=causal),
                     jq, jk, jv)
    want_xla = vjp(jg)
    got = _port_bwd(q, k, v, g, causal)
    for x, wp, wx in zip(got, want_pallas, want_xla):
        np.testing.assert_allclose(x.numpy(), np.asarray(wp), **TOL)
        np.testing.assert_allclose(x.numpy(), np.asarray(wx), **TOL)


def test_bwd_zero_rows_are_zero_and_finite():
    """Causal sq > sk: the first sq - sk queries see no key. Their dq rows
    are exact zeros and every gradient is finite, equal to the XLA VJP
    (tests/test_attention.py:61)."""
    q, k, v, g = _inputs(1, 48, 24, 2, 16, 25)
    dq, dk, dv = _port_bwd(q, k, v, g, True)
    for x in (dq, dk, dv):
        assert torch.isfinite(x).all()
    assert (dq[:, :24] == 0).all()
    _, vjp = jax.vjp(lambda q, k, v: _xla_attention(q, k, v, causal=True),
                     *(jnp.asarray(x) for x in (q, k, v)))
    for x, w in zip((dq, dk, dv), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("sq,sk,causal", [(80, 80, True), (48, 24, True),
                                          (40, 72, False)])
def test_function_on_cpu_matches_plain_autograd(sq, sk, causal):
    """FlashAttention on CPU tensors (the two plain versions) gives the
    output and gradients of autograd through plain_attention."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(2, sq, sk, 2, 16, 9))
    a = [x.clone().requires_grad_() for x in (q, k, v)]
    b = [x.clone().requires_grad_() for x in (q, k, v)]
    out = port_attn.FlashAttention.apply(*a, causal, None)
    ref = port_attn.plain_attention(*b, causal=causal)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    (out * g).sum().backward()
    (ref * g).sum().backward()
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, **TOL)


def test_cuda_wrappers_raise_off_cpu():
    """Off the CPU the backward checks its inputs and raises instead of
    computing on the CPU; a K1 call that needs a gradient but asks for lse
    or kv_len raises instead of dropping the gradient."""
    q = torch.empty((1, 8, 1, 64), device="meta")
    lse = torch.empty((1, 1, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, q, q, q, lse, q)
    r = torch.empty((1, 8, 1, 64), device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        flash_attention(r, r, r, return_lse=True)
    with pytest.raises(ValueError, match="no backward"):
        flash_attention(r, r, r, kv_len=4)
