"""K1 and the fused backward at head dim 256 (csrc/flash_fwd.cu's
flash_fwd_d256_kernel, csrc/flash_bwd.cu's flash_bwd_d256_kernel on the
card): models of the kernels' tile walks, in fp32 torch test code, held
against the plain versions and against the JAX package's Pallas kernels
in interpret mode on the same numpy inputs.

- `_model_fwd` walks the forward as the kernel does: 128-row items (two
  warpgroups of 64 rows), 64-key tiles (zero-filled past Sk, as TMA fills
  them), the whole 256-column O or (where the kernel has few items) O
  split into two 128-column items that both compute S, masking only on
  the tiles that cross kv_len or the warpgroup's causal diagonal, the
  tiles wholly above that diagonal skipped, lse from the running max and
  row sum (written by the first half alone);
- `_model_bwd` walks the backward: 64-key items, 64-query tiles from the
  first that sees a key (rows past Sq zero-filled, their lse and delta
  the prologue's zeros), S^T and dP^T split 32 / 32 by queries between the
  warpgroups, masking only where the kernel masks, the shared P^T and
  dS^T tiles, dK / dV per 128-column half, dQ from fp32 partials per 64
  columns;
- cases: D = 256 and D = 192 zero-padded to 256 (scale of the true D),
  causal and not, Sq != Sk both ways (zero rows), kv_len padding, lengths
  off the 64 / 128 tiles: within 1e-5 of the plain versions and of JAX
  (fp32 on every side, only the order of the sums differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rsvldm_tpu.ops.flash_attention import flash_attention as jax_flash
from rsvldm_tpu.ops.flash_attention import flash_attention_bwd as jax_bwd
from rsvldm_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
D = 256
BLOCK_M, WG_ROWS, KEYS, Q_TILE = 128, 64, 64, 64
LOG2E, LN2, NEG_INF = fa.LOG2E, fa.LN2, fa.NEG_INF


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    mk = lambda s: (rng.standard_normal((b, s, h, d)) * 0.5).astype(np.float32)
    return mk(sq), mk(sk), mk(sk), mk(sq)


def _rows_to(x, n):
    """x [B, S, H, D] zero-filled to n rows, as a TMA box past S."""
    return F.pad(x, (0, 0, 0, 0, 0, n - x.shape[1]))


def _pad_d(x):
    """Zeros along D to 256, as the wrapper pads D=192."""
    return F.pad(x, (0, D - x.shape[-1]))


def _model_fwd(q, k, v, *, causal, kv_len=None, scale=None, o_cols=D):
    b, sq, h, d = q.shape
    assert d == D
    sk = k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    c = (scale if scale is not None else d ** -0.5) * LOG2E
    q_off = kv_len - sq
    kp, vp = (_rows_to(x, -(-sk // KEYS) * KEYS) for x in (k, v))
    out = torch.zeros_like(q)
    lse = torch.zeros((b, h, sq))
    items = [(q_start, col0) for q_start in range(0, sq, BLOCK_M)
             for col0 in range(0, D, o_cols)]
    for q_start, col0 in items:
        cols = slice(col0, col0 + o_cols)
        n_keys = kv_len
        if causal:
            n_keys = min(kv_len, min(q_start + BLOCK_M, sq) + q_off)
        n = -(-n_keys // KEYS) if n_keys > 0 else 0
        for w in range(2):
            row0 = q_start + w * WG_ROWS
            if row0 >= sq:
                continue  # rows past Sq are computed but never stored
            rows = torch.arange(row0, min(row0 + WG_ROWS, sq))
            mask_from = min(kv_len, row0 + q_off + 1) if causal else kv_len
            skip_from = (max(row0 + WG_ROWS + q_off + KEYS - 1, 0) // KEYS
                         if causal else n)
            m = torch.full((b, h, len(rows)), NEG_INF)
            l = torch.zeros_like(m)
            acc = torch.zeros((b, h, len(rows), o_cols))
            for j in range(min(n, skip_from)):
                key = torch.arange(j * KEYS, (j + 1) * KEYS)
                s = torch.einsum("bqhd,bkhd->bhqk", q[:, rows], kp[:, key])
                if (j + 1) * KEYS > mask_from:
                    ok = (key < kv_len)[None, :]
                    if causal:
                        ok = ok & (key[None, :] <= rows[:, None] + q_off)
                    s = s.masked_fill(~ok, float("-inf"))
                mx = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2((m - mx) * c)
                m = mx
                p = torch.exp2(s * c - (mx * c)[..., None])
                l = l * alpha + p.sum(-1)
                acc = (acc * alpha[..., None]
                       + torch.einsum("bhqk,bkhd->bhqd", p,
                                      vp[:, key][..., cols]))
            l_safe = l.clamp_min(1e-30)
            out[:, rows, :, cols] = (acc / l_safe[..., None]).permute(
                0, 2, 1, 3)
            if col0 == 0:
                m_scaled = torch.where(l > 0, m * c,
                                       torch.full_like(m, NEG_INF))
                lse[:, :, rows] = m_scaled * LN2 + torch.log(l_safe)
    return out, lse


def _model_bwd(q, k, v, out, lse, do, *, causal, scale=None):
    b, sq, h, d = q.shape
    assert d == D
    sk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    c = scale * LOG2E
    q_off = sk - sq
    n_qt, n_kt = -(-sq // Q_TILE), -(-sk // KEYS)
    qp, dop = (_rows_to(x, n_qt * Q_TILE) for x in (q, do))
    kp, vp = (_rows_to(x, n_kt * KEYS) for x in (k, v))
    # the prologue's lse*log2e and delta, zeros past Sq
    pad_q = lambda x: F.pad(x, (0, n_qt * Q_TILE - sq))
    lse2 = pad_q(lse * LOG2E)
    delta = pad_q((do * out).sum(-1).transpose(1, 2))
    dq_acc = torch.zeros(qp.shape, dtype=torch.float32)
    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    for kt in range(n_kt):
        k_start = kt * KEYS
        key = torch.arange(k_start, k_start + KEYS)
        j0 = max(k_start - q_off, 0) // Q_TILE if causal else 0
        for j in range(j0, n_qt):
            q0 = j * Q_TILE
            need_mask = (q0 + Q_TILE > sq or k_start + KEYS > sk
                         or (causal and k_start + KEYS - 1 > q0 + q_off))
            pt = torch.zeros((b, h, KEYS, Q_TILE))
            dst = torch.zeros_like(pt)
            for w in range(2):  # warpgroup w's 32 queries
                qs = torch.arange(q0 + 32 * w, q0 + 32 * w + 32)
                st = torch.einsum("bkhd,bqhd->bhkq", kp[:, key], qp[:, qs])
                dpt = torch.einsum("bkhd,bqhd->bhkq", vp[:, key], dop[:, qs])
                p = torch.exp2(st * c - lse2[:, :, None, qs])
                if need_mask:
                    ok = (key < sk)[:, None] & (qs < sq)[None, :]
                    if causal:
                        ok = ok & (key[:, None] <= qs[None, :] + q_off)
                    p = torch.where(ok, p, 0.0)
                pt[..., 32 * w:32 * w + 32] = p
                dst[..., 32 * w:32 * w + 32] = (
                    p * (dpt - delta[:, :, None, qs]) * scale)
            rows = slice(q0, q0 + Q_TILE)
            for w in range(2):  # warpgroup w's 128 columns
                cols = slice(128 * w, 128 * w + 128)
                dv[:, key, :, cols] += torch.einsum("bhkq,bqhd->bkhd", pt,
                                                    dop[:, rows, :, cols])
                dk[:, key, :, cols] += torch.einsum("bhkq,bqhd->bkhd", dst,
                                                    qp[:, rows, :, cols])
                for half in range(2):  # dQ's partials, 64 columns a product
                    cc = slice(128 * w + 64 * half, 128 * w + 64 * half + 64)
                    dq_acc[:, rows, :, cc] += torch.einsum(
                        "bhkq,bkhd->bqhd", dst, kp[:, key][..., cc])
    return dq_acc[:, :sq].to(q.dtype), dk[:, :sk], dv[:, :sk]


def _fwd_at(d, q, k, v, *, causal, kv_len=None, o_cols=D):
    """The model at the true head dim d: run at 256, sliced back."""
    if d == D:
        return _model_fwd(q, k, v, causal=causal, kv_len=kv_len,
                          o_cols=o_cols)
    out, lse = _model_fwd(*(_pad_d(x) for x in (q, k, v)), causal=causal,
                          kv_len=kv_len, scale=d ** -0.5, o_cols=o_cols)
    return out[..., :d], lse


def _bwd_at(d, q, k, v, out, lse, do, *, causal):
    if d == D:
        return _model_bwd(q, k, v, out, lse, do, causal=causal)
    got = _model_bwd(*(_pad_d(x) for x in (q, k, v, out)), lse, _pad_d(do),
                     causal=causal, scale=d ** -0.5)
    return tuple(x[..., :d] for x in got)


# (sq, sk, causal, kv_len): items of 128 rows, tiles of 64 keys / queries
FWD_CASES = [(150, 200, True, None), (200, 150, True, None),
             (300, 300, True, None), (130, 190, False, 140),
             (64, 257, False, None), (77, 120, True, 100)]
BWD_CASES = [(150, 200, True), (200, 150, True), (300, 300, True),
             (130, 190, False), (64, 257, False)]


@pytest.mark.parametrize("d", [256, 192])
@pytest.mark.parametrize("sq,sk,causal,kv_len", FWD_CASES)
def test_tile_model_forward_equals_plain(sq, sk, causal, kv_len, d):
    q, k, v, _ = (torch.from_numpy(x)
                  for x in _inputs(1, sq, sk, 2, d, sq * 3 + sk + d))
    out, lse = _fwd_at(d, q, k, v, causal=causal, kv_len=kv_len)
    want, want_lse = fa.flash_attention_ref(q, k, v, causal=causal,
                                            kv_len=kv_len, return_lse=True)
    torch.testing.assert_close(out, want, **TOL)
    torch.testing.assert_close(lse, want_lse, **TOL)
    if causal and sq > (kv_len or sk):
        assert (out[:, :sq - (kv_len or sk)] == 0).all()


@pytest.mark.parametrize("d", [256, 192])
@pytest.mark.parametrize("sq,sk,causal,kv_len", FWD_CASES)
def test_tile_model_forward_o_split_equals_plain(sq, sk, causal, kv_len, d):
    """The few-items layout: each q tile two items of 128 columns of O."""
    q, k, v, _ = (torch.from_numpy(x)
                  for x in _inputs(1, sq, sk, 2, d, sq * 5 + sk + d))
    out, lse = _fwd_at(d, q, k, v, causal=causal, kv_len=kv_len, o_cols=128)
    want, want_lse = fa.flash_attention_ref(q, k, v, causal=causal,
                                            kv_len=kv_len, return_lse=True)
    torch.testing.assert_close(out, want, **TOL)
    torch.testing.assert_close(lse, want_lse, **TOL)
    if causal and sq > (kv_len or sk):
        assert (out[:, :sq - (kv_len or sk)] == 0).all()


@pytest.mark.parametrize("d", [256, 192])
@pytest.mark.parametrize("sq,sk,causal", BWD_CASES)
def test_tile_model_backward_equals_plain(sq, sk, causal, d):
    q, k, v, g = (torch.from_numpy(x)
                  for x in _inputs(1, sq, sk, 2, d, sq + 5 * sk + d))
    out, lse = fa.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    got = _bwd_at(d, q, k, v, out, lse, g, causal=causal)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, g, causal=causal)
    for x, w in zip(got, want):
        torch.testing.assert_close(x, w, **TOL)
    if causal and sq > sk:
        assert (got[0][:, :sq - sk] == 0).all()


@pytest.mark.parametrize("d,sq,sk,causal", [(256, 150, 200, True),
                                            (192, 200, 150, True),
                                            (256, 130, 190, False)])
def test_tile_model_equals_pallas(d, sq, sk, causal):
    """The models, forward and backward, against JAX's Pallas kernels in
    interpret mode on the same inputs."""
    q, k, v, g = _inputs(1, sq, sk, 2, d, d + sq)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    out_j, lse_j = jax_flash(jq, jk, jv, causal=causal, block_q=64,
                             block_k=64, interpret=True, return_lse=True)
    want = jax_bwd(jq, jk, jv, out_j, lse_j, jg, causal=causal, block_q=64,
                   block_k=64, interpret=True)
    t = [torch.from_numpy(x) for x in (q, k, v, g)]
    out, lse = _fwd_at(d, *t[:3], causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)
    got = _bwd_at(d, *t[:3], out, lse, t[3], causal=causal)
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("d,causal", [(256, True), (192, False)])
def test_tile_model_kv_len_equals_pallas(d, causal):
    """Keys at or past kv_len are padding (here 7.0, not zeros): the model
    on the padded keys against JAX's Pallas forward on the unpadded ones."""
    sq, sk, kv_len = 140, 200, 163
    q, k, v, _ = _inputs(1, sq, sk, 2, d, d + kv_len)
    pad = lambda x: np.concatenate(
        [x[:, :kv_len], np.full_like(x[:, kv_len:], 7.0)], axis=1)
    out, lse = _fwd_at(d, *(torch.from_numpy(x) for x in (q, pad(k), pad(v))),
                       causal=causal, kv_len=kv_len)
    out_j, lse_j = jax_flash(*(jnp.asarray(x) for x in (q, k[:, :kv_len],
                                                        v[:, :kv_len])),
                             causal=causal, block_q=64, block_k=64,
                             interpret=True, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)
