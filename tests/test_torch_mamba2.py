"""The port's Mamba-2 (SSD) block against the JAX package.

* ``_causal_conv``, ``ssd_scan`` (the sequential form) and ``ssd_chunked``
  (the chunked form at the transformer's ``SSD_CHUNK`` of 64) at the zamba2
  SMOKE shapes (d 64, heads of 16, state 8), the reference's weights
  (``mamba_init``, then ``A_log``, ``dt_bias``, ``D``, ``norm_scale`` and
  ``conv_b`` drawn from a seed) carried across into ``mamba2.Mamba2``:
  sequence lengths 1, 31, 64 and 70 (70 leaves a padded tail), without and
  with a carried SSM ``state`` and ``conv_state``; the conv also at a
  ``valid_len`` short of the input. Outputs and returned states against
  the reference's, f32, within atol 1e-5 plus rtol 1e-5 (summation order).
* The port's chunked form against its own sequential form, also at chunk
  16, and two calls carrying both states equal one call (atol 1e-5).
* The gradient of ``ssd_chunked`` where the pairwise log-decays of a chunk
  pass f32's exponent range: finite and equal to ``jax.grad`` of the
  reference's (the mask comes before the exponent: exp(inf) * 0 would
  give NaN); each gradient within 1e-5 of its tensor's largest entry (f32
  sums over 70 tokens; entries reach 128).
* The serving module holds ``A_log``, ``dt_bias``, ``D`` and
  ``norm_scale`` in f32, the rest in the compute dtype; ``init_weights``
  gives the reference's constants.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as ref_mamba
from repro_torch import configs
from repro_torch.models import mamba2
from test_torch_train_forward import one_torch_thread  # noqa: F401 (a fixture)

CFG = configs.get_config("zamba2_1p2b", smoke=True)
ATOL, RTOL = 1e-5, 1e-5
GRAD_REL = 1e-5   # gradients: f32 sums over 70 tokens, held to 1e-5 of each tensor's largest
B = 2
LENGTHS = (1, 31, 64, 70)


def _ref_params(seed: int = 3) -> dict:
    """The reference's init with its constants drawn from a seed."""
    params = jax.tree.map(np.asarray, ref_mamba.mamba_init(jax.random.PRNGKey(seed), CFG))
    rng = np.random.default_rng(seed)
    for name, lo, hi in (("A_log", -1.0, 2.0), ("dt_bias", -3.0, 0.0), ("D", 0.5, 1.5),
                         ("norm_scale", 0.5, 1.5), ("conv_b", -0.2, 0.2)):
        params[name] = rng.uniform(lo, hi, params[name].shape).astype(np.float32)
    return params


def port_module(params: dict, cfg=CFG, dtype=torch.float32) -> mamba2.Mamba2:
    """``mamba2.Mamba2`` holding the reference's weights ``params``."""
    module = mamba2.Mamba2(cfg, "cpu", dtype)
    with torch.no_grad():
        for name in mamba2.FIELDS:
            p = getattr(module, name)
            assert tuple(p.shape) == params[name].shape, name
            p.copy_(torch.from_numpy(np.array(params[name], np.float32)))
    return module


def _inputs(s: int, carried: bool, seed: int):
    rng = np.random.default_rng(seed)
    d_inner, hp, nh, n = mamba2.mamba_dims(CFG)
    u = rng.standard_normal((B, s, CFG.d_model)).astype(np.float32)
    if not carried:
        return u, None, None
    state = (rng.standard_normal((B, nh, hp, n)) * 0.3).astype(np.float32)
    conv = rng.standard_normal((B, mamba2.CONV_W - 1, d_inner + 2 * n)).astype(np.float32)
    return u, state, conv


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("s", LENGTHS)
def test_ssd_forms_match_reference(s, carried):
    params = _ref_params()
    module = port_module(params)
    u, state, conv = _inputs(s, carried, seed=s * 10 + carried)
    jp = jax.tree.map(jnp.asarray, params)
    with torch.no_grad():
        for name, ref_fn, fn, extra in (
                ("ssd_scan", ref_mamba.ssd_scan, mamba2.ssd_scan, {}),
                ("ssd_chunked", ref_mamba.ssd_chunked, mamba2.ssd_chunked, {"chunk": 64})):
            want = jax.jit(lambda p, u, h, c, f=ref_fn, kw=extra: f(
                p, u, CFG, **kw, state=h, conv_state=c))(jp, u, state, conv)
            got = fn(module, torch.from_numpy(u), CFG, **extra, state=_t(state),
                     conv_state=_t(conv))
            for part, g, w in zip(("y", "state", "conv_state"), got, want):
                _close(g, w, f"{name} {part}")


@pytest.mark.parametrize("valid_len", [None, 1, 5, 12])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_causal_conv_matches_reference(carried, valid_len):
    params = _ref_params(4)
    module = port_module(params)
    d_inner, _, _, n = mamba2.mamba_dims(CFG)
    rng = np.random.default_rng(20 + carried)
    xbc = rng.standard_normal((B, 12, d_inner + 2 * n)).astype(np.float32)
    conv = _inputs(1, True, seed=21)[2] if carried else None
    want = ref_mamba._causal_conv(jax.tree.map(jnp.asarray, params), xbc, jnp.float32,
                                  conv_state=conv, valid_len=valid_len)
    got = mamba2._causal_conv(module, torch.from_numpy(xbc), torch.float32,
                              conv_state=_t(conv), valid_len=valid_len)
    for part, g, w in zip(("y", "conv_state"), got, want):
        _close(g, w, f"conv {part}")


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("s", LENGTHS)
def test_chunked_form_equals_scan(s, chunk):
    module = port_module(_ref_params(5))
    u, state, conv = (_t(a) for a in _inputs(s, True, seed=100 + s))
    with torch.no_grad():
        y1, h1, c1 = mamba2.ssd_scan(module, u, CFG, state=state, conv_state=conv)
        y2, h2, c2 = mamba2.ssd_chunked(module, u, CFG, chunk=chunk, state=state,
                                        conv_state=conv)
    for g, w, what in ((y2, y1, "y"), (h2, h1, "state"), (c2, c1, "conv_state")):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=RTOL, err_msg=what)


def test_states_carry_across_calls():
    module = port_module(_ref_params(7))
    u = _t(_inputs(40, False, seed=7)[0])
    with torch.no_grad():
        y_full, h_full, c_full = mamba2.ssd_scan(module, u, CFG)
        ya, ha, ca = mamba2.ssd_chunked(module, u[:, :25], CFG, chunk=16)
        yb, hb, cb = mamba2.ssd_scan(module, u[:, 25:], CFG, state=ha, conv_state=ca)
    np.testing.assert_allclose(torch.cat([ya, yb], 1).numpy(), y_full.numpy(), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(hb.numpy(), h_full.numpy(), atol=ATOL, rtol=RTOL)
    assert torch.equal(cb, c_full)


def test_chunked_gradient_is_finite_past_the_exponent_range():
    """A_log of 6 and dt_bias of 4 make every step's log-decay about -1,600:
    a 70-token chunk's pairwise differences reach 1e5, far past exp's f32
    range above the diagonal. The gradients stay finite and equal the
    reference's."""
    params = _ref_params(8)
    params["A_log"] = np.full_like(params["A_log"], 6.0)
    params["dt_bias"] = np.full_like(params["dt_bias"], 4.0)
    u = _inputs(70, False, seed=9)[0]
    ct = np.random.default_rng(10).standard_normal((B, 70, CFG.d_model)).astype(np.float32)

    def ref_loss(p):
        return jnp.sum(ref_mamba.ssd_chunked(p, u, CFG, chunk=64)[0] * ct)

    want = jax.jit(jax.grad(ref_loss))(jax.tree.map(jnp.asarray, params))
    module = port_module(params)
    y = mamba2.ssd_chunked(module, torch.from_numpy(u), CFG, chunk=64)[0]
    (y * torch.from_numpy(ct)).sum().backward()
    for name in mamba2.FIELDS:
        grad = getattr(module, name).grad
        assert bool(torch.isfinite(grad).all()), name
        _close(grad, want[name], f"d{name}", GRAD_REL * float(np.abs(want[name]).max()), 0)


def test_serving_dtypes_and_init():
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    serve = mamba2.Mamba2(cfg, "cpu")
    for name in mamba2.FIELDS:
        p = getattr(serve, name)
        want = torch.float32 if name in mamba2.F32_READ else torch.bfloat16
        assert p.dtype == want and not p.requires_grad, name
    train = mamba2.Mamba2(CFG, "cpu", torch.float32)
    train.init_weights(torch.Generator().manual_seed(0))
    ref = ref_mamba.mamba_init(jax.random.PRNGKey(0), CFG)
    for name in mamba2.FIELDS:
        got, want = getattr(train, name).detach().numpy(), np.asarray(ref[name])
        assert got.shape == want.shape, name
        if name in ("A_log", "dt_bias", "D", "norm_scale", "conv_b"):
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=name)
        else:   # normals at the reference's scale
            np.testing.assert_allclose(got.std(), want.std(), rtol=0.25, err_msg=name)
