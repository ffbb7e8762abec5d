"""K1's plain version and the attention dispatch of the PyTorch port, held
against the JAX package's Pallas flash attention (interpret mode) and its
XLA attention, on the same numpy inputs. fp32 on the CPU, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsvldm_tpu.ops.attention import _xla_attention
from rsvldm_tpu.ops.flash_attention import flash_attention as jax_flash
from rsvldm_tpu_torch.ops import attention as port_attn
from rsvldm_tpu_torch.ops.flash_attention import (flash_attention,
                                                  flash_attention_ref)

torch.set_num_threads(1)
ATOL = 1e-5  # fp32 on both sides; only the summation order differs


def _qkv(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    mk = lambda s: (rng.standard_normal((b, s, h, d)) * 0.5).astype(np.float32)
    return mk(sq), mk(sk), mk(sk)


@pytest.mark.parametrize("sq,sk,causal", [
    (128, 128, False),
    (128, 77, False),    # cross-attention to text tokens
    (200, 200, False),   # not a multiple of the block
    (128, 128, True),
    (64, 192, True),     # causal sq < sk: suffix-aligned
    (130, 60, True),     # causal sq > sk: rows with no key are zeros
])
def test_ref_matches_pallas_and_xla(sq, sk, causal):
    q, k, v = _qkv(2, sq, sk, 2, 64, sq * 1000 + sk)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    out_j, lse_j = jax_flash(jq, jk, jv, causal=causal, block_q=64,
                             block_k=64, interpret=True, return_lse=True)
    xla = _xla_attention(jq, jk, jv, causal=causal)
    out_t, lse_t = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   return_lse=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(xla), atol=ATOL)
    live = slice(max(sq - sk, 0), None) if causal else slice(None)
    np.testing.assert_allclose(lse_t.numpy()[..., live],
                               np.asarray(lse_j)[..., live], atol=ATOL,
                               rtol=1e-6)
    if causal and sq > sk:
        assert (out_t.numpy()[:, :sq - sk] == 0).all()
        # rows with no key: lse = NEG_INF*ln2 + log(1e-30), as the kernel
        np.testing.assert_allclose(lse_t.numpy()[..., :sq - sk],
                                   np.asarray(lse_j)[..., :sq - sk], rtol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_ref_kv_len_masks_padding(causal):
    """Keys at or past kv_len are padding: the result equals JAX on the
    unpadded keys, causal alignment included."""
    sq, sk, kv_len = 96, 160, 111
    q, k, v = _qkv(1, sq, sk, 2, 128, 5 + causal)
    pad = lambda x: np.concatenate(
        [x, np.full_like(x[:, :sk - kv_len], 7.0)], axis=1)
    out_t, lse_t = flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(pad(k[:, :kv_len])),
        torch.from_numpy(pad(v[:, :kv_len])), causal=causal, kv_len=kv_len,
        return_lse=True)
    out_j, lse_j = jax_flash(jnp.asarray(q), jnp.asarray(k[:, :kv_len]),
                             jnp.asarray(v[:, :kv_len]), causal=causal,
                             block_q=64, block_k=64, interpret=True,
                             return_lse=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL,
                               rtol=1e-6)


@pytest.mark.parametrize("sq,sk,causal", [(40, 40, False), (24, 48, True),
                                          (48, 24, True)])
def test_plain_attention_matches_xla(sq, sk, causal):
    q, k, v = _qkv(2, sq, sk, 3, 16, 11)
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal)
    out = port_attn.attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_long_cpu_sequences_stay_plain():
    """The dispatch sends only CUDA tensors to K1; CPU tensors take the
    plain path and never count a launch."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1024, 1024, 1, 64, 3))
    before = flash_attention.launches
    out = port_attn.attention(q, k, v)
    assert flash_attention.launches == before
    torch.testing.assert_close(out, port_attn.plain_attention(q, k, v))


def test_wrapper_raises_off_cpu_without_kernel():
    """A tensor that is not on the CPU goes to the kernel path, which
    checks its inputs and raises instead of computing on the CPU."""
    q = torch.empty((1, 8, 1, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
