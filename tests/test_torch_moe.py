"""The port's MoE serving path against the JAX package.

* ``plan_groups`` equal to the reference's.
* ``grouped_matmul_padded`` and ``ops.grouped_matmul`` (the CPU side of the
  CUDA kernel ``grouped_matmul.cu``) against the reference's Pallas kernel in
  interpret mode on ragged group sizes and on an N and K that are not
  multiples of the kernel's tile: the whole y, pad rows included, within
  atol 1e-4 (f32, summation order only), offsets equal. The ragged entry
  ``grouped_matmul_ragged`` against ``grouped_matmul_ref``; rows past the
  last group are zeros in the plain version.
* ``moe_apply`` against the reference's on the OLMoE SMOKE config in f32,
  without drops (capacity factor 4) and with them (0.5): y within atol 1e-4,
  aux within 1e-6; against ``moe_apply_dense_oracle`` without drops.
* The OLMoE SMOKE model with the reference's weights carried across:
  prefill, decode steps and ``serve_batch`` (logits atol 1e-4, ids equal);
  ``init_params`` shapes and scales, the router kept in f32.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.kernels import grouped_matmul as ref_gmm
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.launch import serve as ref_serve
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.train.step import make_prefill

ATOL = 1e-4          # f32, summation order only
AUX_ATOL = 1e-6
KEY = jax.random.PRNGKey(0)
CFG = configs.get_config("olmoe-1b-7b", smoke=True)
SIZES = [[37, 0, 91, 12], [1, 1, 1, 1], [128], [0, 64]]


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _jax_params(cfg):
    """The reference's model weights for ``cfg`` (drawn once per config)."""
    return ref_tf.init_params(KEY, cfg)


def _moe_module(cfg, jparams):
    layer = moe.MoE(cfg, device="cpu")
    with torch.no_grad():
        for name in ("router", "w1", "w3", "w2"):
            getattr(layer, name).copy_(torch.from_numpy(np.array(jparams[name])))
    return layer


def _drops(cfg, x, router):
    """Assignments over capacity, counted from the routing alone (numpy)."""
    b, s, _ = x.shape
    logits = x.reshape(b * s, -1).astype(np.float64) @ router.astype(np.float64)
    top = np.argsort(-logits, axis=-1)[:, : cfg.top_k].reshape(b, s * cfg.top_k)
    cap = moe.capacity(cfg, s)
    return int(sum(np.maximum(np.bincount(row, minlength=cfg.n_experts) - cap, 0).sum()
                   for row in top))


# ---------------------------------------------------------------------------
# grouped GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bt", [8, 32, 128])
@pytest.mark.parametrize("sizes", SIZES + [[0, 0, 5]])
def test_plan_groups_equals_reference(sizes, bt):
    got, want = gmm.plan_groups(np.asarray(sizes), bt), ref_gmm.plan_groups(np.asarray(sizes), bt)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    assert got[2] == want[2]


@pytest.mark.parametrize("sizes,k,n,bk,bn", [(s, 64, 96, 32, 32) for s in SIZES]
                         + [([19, 45, 0, 3], 40, 72, 8, 24)])
def test_grouped_matmul_matches_pallas(rng, sizes, k, n, bk, bn):
    """ops.grouped_matmul (host plan, padded layout) against the reference's,
    the whole padded y; then grouped_matmul_padded on the same padded x."""
    e, t = len(sizes), sum(sizes)
    x = rng.standard_normal((t, k)).astype(np.float32)
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    want, want_offs = ref_ops.grouped_matmul(jnp.asarray(x), jnp.asarray(w), sizes,
                                             bt=32, bn=bn, bk=bk, interpret=True)
    got, offs = ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w), sizes,
                                   bt=32, bn=bn, bk=bk)
    np.testing.assert_array_equal(offs, want_offs)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    _, tile_group, t_pad = ref_gmm.plan_groups(np.asarray(sizes), 32)
    xp = np.zeros((t_pad, k), np.float32)
    for g in range(e):
        xp[offs[g]: offs[g] + sizes[g]] = x[sum(sizes[:g]): sum(sizes[: g + 1])]
    want = ref_gmm.grouped_matmul_padded(jnp.asarray(xp), jnp.asarray(w),
                                         jnp.asarray(tile_group), bt=32, bn=bn, bk=bk,
                                         interpret=True)
    got = gmm.grouped_matmul_padded(torch.from_numpy(xp), torch.from_numpy(w),
                                    torch.from_numpy(tile_group), bt=32, bn=bn, bk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert not got[np.setdiff1d(np.arange(t_pad), np.concatenate(
        [np.arange(offs[g], offs[g] + sizes[g]) for g in range(e)]))].any()


def test_grouped_matmul_with_every_group_empty():
    """The reference's kernel fails on the empty tile table; the port gives
    the plan's one tile of zeros."""
    y, offs = ops.grouped_matmul(torch.zeros(0, 16), torch.ones(3, 16, 8), [0, 0, 0], bt=8)
    np.testing.assert_array_equal(offs, ref_gmm.plan_groups(np.zeros(3), 8)[0])
    assert tuple(y.shape) == (8, 8) and not y.any()
    seg = torch.zeros(4, dtype=torch.int64)
    assert not gmm.grouped_matmul_ragged(torch.ones(5, 16), torch.ones(3, 16, 8), seg).any()


def test_grouped_matmul_ref_matches_reference(rng):
    x = rng.standard_normal((20, 16)).astype(np.float32)
    w = rng.standard_normal((3, 16, 24)).astype(np.float32)
    tg = rng.integers(0, 3, 20).astype(np.int32)
    want = ref_ref.grouped_matmul_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(tg))
    got = ref.grouped_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(tg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_ragged_matches_oracle(rng, sizes, out_dtype):
    """The model's entry: groups back to back, unpadded, and 7 rows past the
    last group that are not computed (zeros in the plain version)."""
    e, t, k, n = len(sizes), sum(sizes), 40, 72
    x = torch.from_numpy(rng.standard_normal((t + 7, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((e, k, n)).astype(np.float32))
    seg_rows = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int64)
    got = gmm.grouped_matmul_ragged(x, w, seg_rows, out_dtype)
    want = ref.grouped_matmul_ref(x[:t], w, torch.repeat_interleave(
        torch.arange(e), torch.tensor(sizes)))
    assert got.dtype == out_dtype and tuple(got.shape) == (t + 7, n)
    # bf16: one rounding step of the output (f32 sums in another order can
    # fall on either side of a rounding boundary)
    rtol = 0 if out_dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got[:t].float(), want.to(out_dtype).float(), atol=ATOL,
                               rtol=rtol)
    assert not got[t:].any()
    assert torch.equal(ops.grouped_matmul_ragged(x, w, seg_rows, out_dtype), got)


def test_grouped_matmul_wrappers_refuse_bad_operands():
    x, w = torch.zeros(64, 16), torch.zeros(2, 16, 32)
    with pytest.raises(ValueError, match="expected"):
        gmm.grouped_matmul_ragged(x, torch.zeros(2, 8, 32), torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="seg_rows"):
        gmm.grouped_matmul_ragged(x, w, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="divisible"):
        gmm.grouped_matmul_padded(x, w, torch.zeros(2, dtype=torch.int32), bt=32, bk=12)
    with pytest.raises(ValueError, match="group ids"):
        gmm.grouped_matmul_padded(x, w, torch.tensor([0, 2], dtype=torch.int32), bt=32,
                                  bn=32, bk=16)
    with pytest.raises(ValueError, match="group ids"):
        gmm.grouped_matmul_padded(x, w, torch.zeros(3, dtype=torch.int32), bt=32, bn=32,
                                  bk=16)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor,s", [(4.0, 24), (0.5, 40)],
                         ids=["no_drops", "drops"])
def test_moe_apply_matches_reference(rng, capacity_factor, s):
    cfg = dataclasses.replace(CFG, capacity_factor=capacity_factor)
    jparams = ref_moe.moe_init(KEY, cfg)
    x = rng.standard_normal((3, s, cfg.d_model)).astype(np.float32)
    drops = _drops(cfg, x, np.asarray(jparams["router"]))
    assert (drops > 0) == (capacity_factor < 1), drops
    want_y, want_aux = ref_moe.moe_apply(jparams, jnp.asarray(x), cfg)
    layer = _moe_module(cfg, jparams)
    with torch.inference_mode():
        y, aux = moe.moe_apply(layer, torch.from_numpy(x), cfg)
        y_module = layer(torch.from_numpy(x))
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=AUX_ATOL, rtol=0)
    assert torch.equal(y_module, y)


def test_moe_apply_matches_dense_oracle(rng):
    cfg = CFG   # capacity factor 4: nothing drops
    jparams = ref_moe.moe_init(jax.random.PRNGKey(5), cfg)
    layer = _moe_module(cfg, jparams)
    x = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32))
    assert _drops(cfg, x.numpy(), np.asarray(jparams["router"])) == 0
    with torch.inference_mode():
        y, _ = moe.moe_apply(layer, x, cfg)
        oracle = moe.moe_apply_dense_oracle(layer, x, cfg)
    torch.testing.assert_close(y, oracle, atol=ATOL, rtol=0)
    want = ref_moe.moe_apply_dense_oracle(jparams, jnp.asarray(x.numpy()), cfg)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_capacity_equals_reference():
    for cfg in (CFG, configs.get_config("olmoe-1b-7b")):
        for n_tokens in (1, 7, 24, 1937, 4096):
            assert moe.capacity(cfg, n_tokens) == ref_moe.capacity(cfg, n_tokens)
    full = configs.get_config("olmoe-1b-7b")
    assert moe.capacity(full, 1) == 8 and moe.capacity(full, 1937) == 304


def test_moe_layer_calls_the_grouped_gemm_three_times_through_ops(rng):
    layer = _moe_module(CFG, ref_moe.moe_init(KEY, CFG))
    x = torch.from_numpy(rng.standard_normal((2, 5, CFG.d_model)).astype(np.float32))
    calls = []

    def spy(x_, w_, seg_rows, out_dtype=None):
        calls.append((tuple(x_.shape), seg_rows.tolist()))
        return gmm.grouped_matmul_plain(x_, w_, seg_rows, out_dtype=out_dtype)
    with mock.patch.object(ops, "grouped_matmul_ragged", spy), torch.inference_mode():
        layer(x)
    n = 2 * 5 * CFG.top_k
    assert [c[0] for c in calls] == [(n, CFG.d_model), (n, CFG.d_model), (n, CFG.d_ff)]
    seg = calls[0][1]
    assert len(seg) == CFG.n_experts + 1 and seg[0] == 0 and seg[-1] == n
    assert all(c[1] == seg for c in calls)


# ---------------------------------------------------------------------------
# the OLMoE SMOKE model
# ---------------------------------------------------------------------------


def test_params_from_jax_carries_the_moe_tree():
    jparams = _jax_params(CFG)
    model = params_from_jax(_numpy_tree(jparams), CFG, device="cpu")
    for i, layer in enumerate(model.layers):
        assert not hasattr(layer, "mlp")
        for name in ("router", "w1", "w3", "w2"):
            np.testing.assert_array_equal(getattr(layer.moe, name).numpy(),
                                          np.asarray(jparams["layers"]["moe"][name])[i])
    bad = _numpy_tree(jparams)
    bad["layers"]["moe"]["w2"] = bad["layers"]["moe"]["w2"][:, :, :-1]
    with pytest.raises(ValueError, match="moe/w2"):
        params_from_jax(bad, CFG, device="cpu")


def test_init_params_shapes_scales_and_router_dtype():
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16", d_model=128, d_ff=64)
    model = tf.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    want = jax.eval_shape(lambda k: ref_tf.init_params(k, cfg), KEY)
    layer0 = model.layers[0].moe
    for name in ("router", "w1", "w3", "w2"):
        assert (cfg.n_layers, *getattr(layer0, name).shape) == \
            want["layers"]["moe"][name].shape, name
    assert layer0.router.dtype == torch.float32
    assert layer0.w1.dtype == layer0.w3.dtype == layer0.w2.dtype == torch.bfloat16
    d, ff = cfg.d_model, cfg.d_ff
    for w, scale in ((layer0.router, d ** -0.5), (layer0.w1, d ** -0.5),
                     (layer0.w3, d ** -0.5), (layer0.w2, ff ** -0.5)):
        assert abs(float(w.float().std()) / scale - 1) < 0.1
    # param_count leaves out the final norm's d scales
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() + d
    again = tf.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def test_olmoe_full_config_counts():
    cfg, want = configs.get_config("olmoe-1b-7b"), ref_configs.get_config("olmoe-1b-7b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.param_count() == 6_919_094_272


def test_prefill_and_decode_match_reference(rng):
    jparams = _jax_params(CFG)
    model = params_from_jax(_numpy_tree(jparams), CFG, device="cpu")
    lens = np.array([9, 21, 14], np.int32)
    toks = np.zeros((3, 21), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, CFG.vocab_size, n)
    cache_len = 32
    want, jcache = ref_tf.prefill(jparams, {"tokens": jnp.asarray(toks),
                                            "lengths": jnp.asarray(lens)}, CFG, cache_len)
    with torch.inference_mode():
        got, cache = make_prefill(CFG, cache_len)(
            model, {"tokens": torch.from_numpy(toks), "lengths": torch.from_numpy(lens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), atol=ATOL,
                                   rtol=0)
    step = jnp.argmax(want, axis=-1).astype(jnp.int32)[:, None]
    for _ in range(3):
        want, jcache = ref_tf.decode_step(jparams, jcache, step, CFG)
        with torch.inference_mode():
            got, cache = tf.decode_step(model, cache, torch.from_numpy(np.asarray(step)), CFG)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))
        step = jnp.argmax(want, axis=-1).astype(jnp.int32)[:, None]
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_prefill_with_drops_matches_reference(rng):
    """A capacity factor that drops assignments at prefill (pads count toward
    each row's capacity, as in the reference)."""
    cfg = dataclasses.replace(CFG, capacity_factor=0.5)
    jparams = _jax_params(cfg)
    model = params_from_jax(_numpy_tree(jparams), cfg, device="cpu")
    toks = rng.integers(1, cfg.vocab_size, (2, 40)).astype(np.int32)
    want, _ = ref_tf.prefill(jparams, {"tokens": jnp.asarray(toks)}, cfg, 48)
    with torch.inference_mode():
        got, _ = tf.prefill(model, {"tokens": torch.from_numpy(toks)}, cfg, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_serve_batch_matches_reference(rng):
    jparams = _jax_params(CFG)
    model = params_from_jax(_numpy_tree(jparams), CFG, device="cpu")
    prompts = [rng.integers(1, CFG.vocab_size, n).tolist() for n in (5, 12, 8, 3)]
    want, _ = ref_serve.serve_batch(CFG, prompts, max_new_tokens=6, cache_len=32,
                                    params=jparams)
    got, stats = serve.serve_batch(CFG, prompts, max_new_tokens=6, cache_len=32,
                                   params=model, device="cpu")
    assert got == want
    assert stats.prompts == 4 and stats.generated_tokens == 24


def test_serve_main_runs_olmoe_on_the_cpu(capsys):
    serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu", "--batch", "2",
                "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert out.count("[serve] seq") == 2 and "tok/s decode" in out
