"""The attention kernels' plain versions against the JAX package.

* ``flash_prefill_plain`` (the CPU side of ``ops.flash_prefill``) against
  the reference Pallas kernel ``repro.kernels.ops.flash_prefill`` in
  interpret mode, block sizes 16-32, g in {1, 4}, window in {0, 24}, f32 to
  atol 1e-5 (summation order only), and one bf16 case at the reference
  test's own tolerance (4e-2); ragged S against the reference's pure
  ``flash_attention``, which pads as the plain version does.
* ``decode_attention_plain`` against ``ops.decode_attention`` in interpret
  mode and ``ref.decode_attention_ref``, with ragged lengths.
* Both plain versions at the GQA widths of the other ported configs, g in
  {3, 8, 9} (minitron-4b, deepseek-67b, starcoder2-7b) at D = 128, against
  the Pallas kernels in interpret mode, narrow and short; g = 9 does not
  divide the card kernels' 64-row query tile.
* ``models.attention.flash_attention`` / ``attention_ref`` against the
  reference's functions of those names (non-causal and offset queries too).
* The wrappers refuse operands that do not fit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import attention as ref_att
from repro_torch.kernels import chunked_attention, flash_prefill, ops, ref
from repro_torch.models import attention as att

ATOL = 1e-5          # f32, summation order only
BF16_TOL = 4e-2      # the reference test's bf16 tolerance (test_flash_prefill_dtypes)


def _qkv(rng, b, sq, h, hkv, d, sk=None, dtype=np.float32):
    sk = sq if sk is None else sk
    return (rng.standard_normal((b, sq, h, d)).astype(dtype),
            rng.standard_normal((b, sk, hkv, d)).astype(dtype),
            rng.standard_normal((b, sk, hkv, d)).astype(dtype))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("bq,bk", [(16, 32), (32, 16)])
def test_flash_prefill_plain_matches_pallas(rng, bq, bk, g, window):
    b, s, hkv, d = 2, 64, 2, 16
    q, k, v = _qkv(rng, b, s, g * hkv, hkv, d)
    want = np.asarray(ref_ops.flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            bq=bq, bk=bk, window=window, interpret=True))
    got = ops.flash_prefill(*_t(q, k, v), bq=bq, bk=bk, window=window)
    assert got.dtype == torch.float32 and got.shape == (b, s, g * hkv, d)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the plain version's block sizes do not change the function
    other = flash_prefill.flash_prefill_plain(*_t(q, k, v), window=window, bq=64, bk=8)
    np.testing.assert_allclose(other.numpy(), want, atol=ATOL, rtol=0)


def test_flash_prefill_plain_bf16(rng):
    b, s, h, hkv, d = 2, 64, 8, 2, 16
    q, k, v = (jnp.asarray(x, jnp.bfloat16) for x in _qkv(rng, b, s, h, hkv, d))
    want = np.asarray(ref_ops.flash_prefill(q, k, v, bq=32, bk=32, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (q, k, v))
    got = ops.flash_prefill(tq, tk, tv, bq=32, bk=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("s,window,g", [(50, 0, 4), (50, 24, 1), (23, 0, 4)])
def test_flash_prefill_plain_ragged(rng, s, window, g):
    """S not a block multiple: the plain version pads, as the reference's
    pure flash_attention does (the Pallas kernel refuses such S)."""
    b, hkv, d = 2, 2, 16
    q, k, v = _qkv(rng, b, s, g * hkv, hkv, d)
    want = np.asarray(ref_att.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              causal=True, window=window, q_chunk=16,
                                              kv_chunk=16))
    got = ops.flash_prefill(*_t(q, k, v), bq=16, bk=16, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal,window,sq,sk", [(True, 8, 32, 64), (False, 24, 40, 40)])
def test_flash_attention_and_ref_match_reference(rng, causal, window, sq, sk):
    b, h, hkv, d = 2, 8, 2, 16
    q, k, v = _qkv(rng, b, sq, h, hkv, d, sk=sk)
    off = sk - sq
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want = np.asarray(ref_att.flash_attention(jq, jk, jv, causal=causal, window=window,
                                              q_chunk=16, kv_chunk=16, q_offset=off))
    got = att.flash_attention(*_t(q, k, v), causal=causal, window=window, q_chunk=16,
                              kv_chunk=16, q_offset=off)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    want_ref = np.asarray(ref_att.attention_ref(jq, jk, jv, causal=causal, window=window,
                                                q_offset=off))
    got_ref = att.attention_ref(*_t(q, k, v), causal=causal, window=window, q_offset=off)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), got_ref.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("s,bs_kv", [(128, 32), (64, 64)])
@pytest.mark.parametrize("g", [1, 4])
def test_decode_attention_plain_matches_pallas_and_ref(rng, s, bs_kv, g):
    b, hkv, d = 4, 2, 32
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    lengths = np.array([s, s // 2 + 3, 1, 37], np.int32)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths))
    want = np.asarray(ref_ops.decode_attention(*jargs, bs_kv=bs_kv, interpret=True))
    want_ref = np.asarray(ref_ref.decode_attention_ref(*jargs))
    targs = _t(q, k, v, lengths)
    got = ops.decode_attention(*targs)
    assert got.dtype == torch.float32 and got.shape == (b, hkv, g, d)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ref.decode_attention_ref(*targs).numpy(), want_ref,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("g", [3, 8, 9])
def test_flash_prefill_plain_wide_gqa_d128(rng, g, window):
    b, s, hkv, d = 1, 32, 1, 128
    q, k, v = _qkv(rng, b, s, g * hkv, hkv, d)
    want = np.asarray(ref_ops.flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            bq=16, bk=16, window=window, interpret=True))
    got = ops.flash_prefill(*_t(q, k, v), bq=16, bk=16, window=window)
    assert got.shape == (b, s, g * hkv, d)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("g", [3, 8, 9])
def test_decode_attention_plain_wide_gqa_d128(rng, g):
    b, hkv, d, s = 3, 1, 128, 64
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    lengths = np.array([s, 33, 1], np.int32)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths))
    want = np.asarray(ref_ops.decode_attention(*jargs, bs_kv=32, interpret=True))
    got = ops.decode_attention(*_t(q, k, v, lengths))
    assert got.shape == (b, hkv, g, d)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_decode_attention_plain_bf16_and_empty_length(rng):
    b, hkv, g, d, s = 3, 2, 2, 32, 64
    q = jnp.asarray(rng.standard_normal((b, hkv, g, d)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((b, s, hkv, d)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((b, s, hkv, d)), jnp.bfloat16)
    lengths = np.array([s, 5, 0], np.int32)
    want = np.asarray(ref_ops.decode_attention(q, k, v, jnp.asarray(lengths), bs_kv=32,
                                               interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (q, k, v))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got[:2].float().numpy(), want[:2], atol=3e-2, rtol=3e-2)
    # a sequence of length 0 gets zeros (the reference's kernel divides 0 by 0)
    assert torch.equal(got[2], torch.zeros_like(got[2]))


def test_wrappers_refuse_operands_that_do_not_fit():
    q = torch.zeros(2, 8, 4, 16)
    k = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError):
        flash_prefill.flash_prefill(q, k, torch.zeros(2, 8, 2, 8))
    with pytest.raises(ValueError):
        flash_prefill.flash_prefill(q, torch.zeros(2, 8, 3, 16), torch.zeros(2, 8, 3, 16))
    with pytest.raises(ValueError):
        flash_prefill.flash_prefill(q, k, k, window=-1)
    qd = torch.zeros(2, 2, 2, 16)
    with pytest.raises(ValueError):
        chunked_attention.decode_attention(qd, k, k, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        chunked_attention.decode_attention(qd, torch.zeros(2, 8, 3, 16),
                                           torch.zeros(2, 8, 3, 16),
                                           torch.ones(2, dtype=torch.int32))


def test_wrappers_never_fall_back_off_the_cpu():
    """Off the CPU a wrapper launches its kernel or raises: operands the
    kernel does not take (here float16, or D = 16) raise instead of taking the
    plain version (meta tensors stand in for the card's)."""
    q = torch.zeros(1, 8, 4, 64, dtype=torch.float16, device="meta")
    k = torch.zeros(1, 8, 2, 64, dtype=torch.float16, device="meta")
    with pytest.raises(ValueError, match="kernel takes"):
        flash_prefill.flash_prefill(q, k, k)
    q16 = torch.zeros(1, 8, 4, 16, device="meta")
    k16 = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="kernel takes"):
        flash_prefill.flash_prefill(q16, k16, k16)
    qd = torch.zeros(1, 2, 2, 64, dtype=torch.float16, device="meta")
    with pytest.raises(ValueError, match="kernel takes"):
        chunked_attention.decode_attention(qd, k, k, torch.ones(1, dtype=torch.int32,
                                                                device="meta"))
