"""The port's RWKV-6 time and channel mixing against the JAX package.

* ``time_mix`` (the sequential form), ``time_mix_chunked`` (the chunked
  form at the transformer's ``RWKV_CHUNK`` of 32) and ``channel_mix`` at the
  rwkv6 SMOKE shapes (d 64, heads of 16, d_ff 128), the reference's weights
  (``rwkv_init``, then ``mix_mu``, ``w0``, ``ln_x`` and the channel mix's
  mus drawn from a seed) carried across into ``rwkv6.RWKV``: sequence
  lengths 1, 31, 32 and 45 (45 not a multiple of the chunk), without and
  with a carried ``state`` and ``x_prev_in``. The outputs, the returned
  states and the last inputs against the reference's, f32: within atol 1e-5
  plus rtol 1e-5 (f32 summation order: the chunked form divides keys by
  in-chunk cumulative decays, which scale a term's rounding; states reach
  13 in magnitude, where an f32 ulp is 1e-6).
* The port's chunked form against its own sequential form, also at chunk
  16 (atol 1e-5, rtol 1e-5); two calls carrying the state and last input
  equal one call.
* Where the reference's chunked form overflows (decays past e^-88 in a
  chunk) and returns non-finite values, the port's stays finite and equal
  to its sequential form (states within 1e-5, outputs within 1e-3: the
  group norm rescales the small outputs of strongly decayed heads).
* The serving module (``dtype=None``) holds ``w0``, ``u`` and ``ln_x`` in
  f32 and the rest in the compute dtype; ``init_weights`` gives the
  reference's constants and scales.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as ref_rwkv
from repro_torch import configs
from repro_torch.models import rwkv6
from test_torch_train_forward import one_torch_thread  # noqa: F401 (a fixture)

CFG = configs.get_config("rwkv6_3b", smoke=True)
ATOL, RTOL = 1e-5, 1e-5   # outputs and states, f32 summation order
SELF_ATOL = 1e-5          # the port's chunked form against its sequential form
# outputs under decays past e^-88 a chunk: the per-head group norm (ln_x)
# rescales heads whose outputs the strong decays leave small, and with them
# f32 rounding (measured 1.1e-4; the states there agree within SELF_ATOL)
STRONG_DECAY_Y_ATOL = 1e-3
B = 2
LENGTHS = (1, 31, 32, 45)


def _ref_params(seed: int = 3) -> dict:
    """The reference's init, with its constant vectors drawn from a seed so
    that a mix-up of them shows."""
    params = jax.tree.map(np.asarray, ref_rwkv.rwkv_init(jax.random.PRNGKey(seed), CFG))
    rng = np.random.default_rng(seed)
    for name, lo, hi in (("mix_mu", 0.1, 0.9), ("w0", -1.5, 0.5), ("ln_x", 0.5, 1.5),
                         ("cm_mu_k", 0.1, 0.9), ("cm_mu_r", 0.1, 0.9)):
        params[name] = rng.uniform(lo, hi, params[name].shape).astype(np.float32)
    return params


def port_module(params: dict, cfg=CFG, dtype=torch.float32) -> rwkv6.RWKV:
    """``rwkv6.RWKV`` holding the reference's weights ``params``."""
    module = rwkv6.RWKV(cfg, "cpu", dtype)
    with torch.no_grad():
        for name in rwkv6.FIELDS:
            p = getattr(module, name)
            assert tuple(p.shape) == params[name].shape, name
            p.copy_(torch.from_numpy(np.array(params[name], np.float32)))
    return module


def _inputs(s: int, carried: bool, seed: int):
    rng = np.random.default_rng(seed)
    d, hp = CFG.d_model, CFG.ssm_head_dim
    x = rng.standard_normal((B, s, d)).astype(np.float32)
    if not carried:
        return x, None, None
    state = (rng.standard_normal((B, d // hp, hp, hp)) * 0.3).astype(np.float32)
    x_prev = rng.standard_normal((B, d)).astype(np.float32)
    return x, state, x_prev


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL,
                               err_msg=what)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("s", LENGTHS)
def test_time_and_channel_mix_match_reference(s, carried):
    params = _ref_params()
    module = port_module(params)
    x, state, x_prev = _inputs(s, carried, seed=s * 10 + carried)
    jp = jax.tree.map(jax.numpy.asarray, params)
    kw_ref = {"state": state, "x_prev_in": x_prev}
    kw = {"state": _t(state), "x_prev_in": _t(x_prev)}
    with torch.no_grad():
        for name, ref_fn, fn, extra in (
                ("time_mix", ref_rwkv.time_mix, rwkv6.time_mix, {}),
                ("time_mix_chunked", ref_rwkv.time_mix_chunked, rwkv6.time_mix_chunked,
                 {"chunk": 32})):
            want = jax.jit(lambda p, x, kw, f=ref_fn, ex=extra: f(p, x, CFG, **ex, **kw))(
                jp, x, kw_ref)
            got = fn(module, torch.from_numpy(x), CFG, **extra, **kw)
            for part, g, w in zip(("y", "state", "x_last"), got, want):
                _close(g, w, f"{name} {part}")
        want = jax.jit(lambda p, x, xp: ref_rwkv.channel_mix(p, x, CFG, x_prev_in=xp))(
            jp, x, x_prev)
        got = rwkv6.channel_mix(module, torch.from_numpy(x), CFG, x_prev_in=_t(x_prev))
        for part, g, w in zip(("y", "x_last"), got, want):
            _close(g, w, f"channel_mix {part}")


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("s", LENGTHS)
def test_chunked_form_equals_sequential(s, chunk):
    module = port_module(_ref_params(5))
    x, state, x_prev = (_t(a) for a in _inputs(s, True, seed=100 + s))
    with torch.no_grad():
        y1, s1, x1 = rwkv6.time_mix(module, x, CFG, state=state, x_prev_in=x_prev)
        y2, s2, x2 = rwkv6.time_mix_chunked(module, x, CFG, chunk=chunk, state=state,
                                            x_prev_in=x_prev)
    np.testing.assert_allclose(y2.numpy(), y1.numpy(), atol=SELF_ATOL, rtol=RTOL)
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), atol=SELF_ATOL, rtol=RTOL)
    assert torch.equal(x1, x2)


def test_streaming_state_carries_across_calls():
    """Two calls with the carried state and last input equal one call."""
    module = port_module(_ref_params(7))
    x = _t(_inputs(40, False, seed=7)[0])
    with torch.no_grad():
        y_full, s_full, _ = rwkv6.time_mix(module, x, CFG)
        ya, sa, xa = rwkv6.time_mix_chunked(module, x[:, :25], CFG, chunk=32)
        yb, sb, _ = rwkv6.time_mix(module, x[:, 25:], CFG, state=sa, x_prev_in=xa)
    np.testing.assert_allclose(torch.cat([ya, yb], 1).numpy(), y_full.numpy(),
                               atol=SELF_ATOL, rtol=0)
    np.testing.assert_allclose(sb.numpy(), s_full.numpy(), atol=SELF_ATOL, rtol=0)


def test_chunked_form_stays_finite_where_the_reference_overflows():
    """``w0`` of 1.5 gives a decay rate of 4.5 a step: a 32-token chunk's
    cumulative decay passes e^-88, where the reference's factored form
    (k_j / prod_{i<=j} w_i) overflows and returns non-finite values. The
    port's pairwise form stays finite and equal to the sequential form."""
    params = _ref_params(9)
    params["w0"] = np.full_like(params["w0"], 1.5)
    x = _inputs(64, False, seed=9)[0]
    want = ref_rwkv.time_mix_chunked(jax.tree.map(jax.numpy.asarray, params), x, CFG, chunk=32)
    assert not bool(np.isfinite(np.asarray(want[0])).all())
    module = port_module(params)
    with torch.no_grad():
        y, s, _ = rwkv6.time_mix_chunked(module, torch.from_numpy(x), CFG, chunk=32)
        y1, s1, _ = rwkv6.time_mix(module, torch.from_numpy(x), CFG)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    np.testing.assert_allclose(y.numpy(), y1.numpy(), atol=STRONG_DECAY_Y_ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), s1.numpy(), atol=SELF_ATOL, rtol=RTOL)


def test_serving_dtypes_and_init():
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    serve = rwkv6.RWKV(cfg, "cpu")
    for name in rwkv6.FIELDS:
        p = getattr(serve, name)
        want = torch.float32 if name in rwkv6.F32_READ else torch.bfloat16
        assert p.dtype == want and not p.requires_grad, name
    train = rwkv6.RWKV(CFG, "cpu", torch.float32)
    train.init_weights(torch.Generator().manual_seed(0))
    ref = ref_rwkv.rwkv_init(jax.random.PRNGKey(0), CFG)
    for name in rwkv6.FIELDS:
        got, want = getattr(train, name).detach().numpy(), np.asarray(ref[name])
        assert got.shape == want.shape, name
        if name in ("mix_mu", "w0", "ln_x", "cm_mu_k", "cm_mu_r"):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:   # normals at the reference's scale
            np.testing.assert_allclose(got.std(), want.std(), rtol=0.25, err_msg=name)
