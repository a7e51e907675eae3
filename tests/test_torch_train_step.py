"""The port's optimizer, gradient compression and train step against the
JAX package.

* ``lr_schedule``: warmup, cosine and floor values equal to the
  reference's within rtol 1e-6 (f32 math on both sides).
* ``adamw_update`` on identical gradients, two steps, with and without
  clipping: parameters and moments within atol 1e-6, ``grad_norm`` and
  ``lr`` within rtol 1e-6; clipping engages (the reference test's case).
* ``compress_grads``: int8 codes and per-tensor scales equal to the
  reference's exactly (a name's tensors in every layer sharing the scale of
  the reference's stacked leaf), error feedback within atol 1e-6 (one f32
  ulp of the gradients: the jitted reference fuses ``g - q * scale``); the
  error-feedback mean converges to the gradient.
* ``make_train_step``: two steps of the llama SMOKE config (f32) with
  microbatches 1 and 2, and with int8 compression, against the reference's
  jitted step from the same weights and batches. The gradients differ from
  the reference's by f32 summation order (about 1e-7), so the moments are
  held at atol 1e-6 (``mu``) and 1e-8 (``nu``). At step 1 AdamW moves a
  parameter by ``lr * g / (|g| + eps)``, whose slope in g is up to 1 /
  eps: with the default eps (1e-8) a gradient within 1e-7 of zero can
  swing its parameter by up to 2 lr, so these runs take eps = 1e-3 (slope
  at most 1e3) and hold parameters at atol 1e-6. Under int8 an f32
  difference can move a gradient across a rounding boundary of its code,
  by one quantum: there, at least 99% of each tensor's entries (parameters,
  moments and residuals) are held as above, every parameter within 2 lr a
  step, and ``grad_norm`` (of the dequantized gradients) within rtol 1e-3
  (1e-5 without int8).
* Microbatches 1 and 2 give the same step in the port (atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compress as ref_compress
from repro.train import optim as ref_optim
from repro.train import step as ref_step
from repro_torch import configs
from repro_torch.models import transformer as tf
from repro_torch.models.layers import pdtype
from repro_torch.train import compress, optim
from repro_torch.train.step import init_opt_state, make_train_step
from test_torch_train_forward import one_torch_thread, ref_tree  # noqa: F401 (a fixture)

CFG = configs.get_config("llama3.2-1b", smoke=True)
ADAMW_ATOL = 1e-6
MU_ATOL, NU_ATOL, PARAM_ATOL = 1e-6, 1e-8, 1e-6
LOSS_ATOL = 1e-5
EF_ATOL = 1e-6          # an f32 ulp of gradients up to 8: XLA fuses g - q * scale
STEP_EPS = 1e-3         # see the module docstring
INT8_AGREE = 0.99       # share of entries held tightly under int8


def _tensors(rng, shapes, scale=1.0):
    return {n: (rng.standard_normal(s) * scale).astype(np.float32) for n, s in shapes.items()}


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return {n: torch.from_numpy(np.array(v)) for n, v in tree.items()}


# ---------------------------------------------------------------------------
# schedule, AdamW, clipping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tcfg", [
    optim.TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100, min_lr_fraction=0.1),
    optim.TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=8),
    optim.TrainConfig(learning_rate=6e-4, warmup_steps=0, total_steps=1)])
def test_lr_schedule_matches_reference(tcfg):
    ref_cfg = ref_optim.TrainConfig(**tcfg.__dict__)
    for step in (0, 1, 2, 5, 8, 9, 10, 11, 55, 99, 100, 150):
        got = float(optim.lr_schedule(tcfg, step))
        want = float(ref_optim.lr_schedule(ref_cfg, step))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=str(step))
    if tcfg.warmup_steps == 10:
        assert float(optim.lr_schedule(tcfg, 0)) == 0.0
        assert float(optim.lr_schedule(tcfg, 100)) == pytest.approx(1e-4, rel=1e-2)


@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_adamw_update_matches_reference_on_identical_gradients(clip_norm):
    rng = np.random.default_rng(4)
    shapes = {"w": (8, 8), "b": (17,), "e": (5, 3, 4)}
    params, tcfg = _tensors(rng, shapes), optim.TrainConfig(clip_norm=clip_norm,
                                                           warmup_steps=1, total_steps=10)
    ref_cfg = ref_optim.TrainConfig(**tcfg.__dict__)
    p_ref, s_ref = _jnp(params), ref_optim.adamw_init(_jnp(params))
    p, s = _torch(params), optim.adamw_init(_torch(params))
    ref_update = jax.jit(ref_optim.adamw_update, static_argnums=0)
    for _ in range(2):
        grads = _tensors(rng, shapes, scale=0.3)
        p_ref, s_ref, m_ref = ref_update(ref_cfg, p_ref, _jnp(grads), s_ref)
        p, s, m = optim.adamw_update(tcfg, p, _torch(grads), s)
        for n in shapes:
            for got, want in ((p[n], p_ref[n]), (s["mu"][n], s_ref["mu"][n]),
                              (s["nu"][n], s_ref["nu"][n])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ADAMW_ATOL,
                                           rtol=0, err_msg=n)
        assert int(s["step"]) == int(s_ref["step"]) and s["step"].dtype == torch.int32
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(m_ref[key]), rtol=1e-6)
    if clip_norm == 1.0:
        assert float(m["grad_norm"]) > clip_norm   # the clip engaged


def test_clipping_engages():
    tcfg = optim.TrainConfig(clip_norm=0.001)
    p = {"w": torch.ones(4, 4)}
    g = {"w": torch.full((4, 4), 100.0)}
    p2, _, m = optim.adamw_update(tcfg, p, g, optim.adamw_init(p))
    assert float(m["grad_norm"]) == pytest.approx(400.0)
    assert torch.isfinite(p2["w"]).all()


# ---------------------------------------------------------------------------
# int8 compression with error feedback
# ---------------------------------------------------------------------------


def test_compress_grads_equal_reference():
    rng = np.random.default_rng(5)
    shapes = {"a": (64, 64), "b": (17,), "c": (3, 5, 7)}
    grads = _tensors(rng, shapes)
    grads["b"] *= 10
    grads["c"] *= 1e-3
    ef = _tensors(rng, shapes, scale=1e-3)
    q, ef2 = compress.compress_grads(_torch(grads), _torch(ef))
    q_ref, ef2_ref = jax.jit(ref_compress.compress_grads)(_jnp(grads), _jnp(ef))
    deq_ref = jax.jit(ref_compress.decompress_grads)(q_ref)
    for n in shapes:
        code, scale = q[n]
        code_ref, scale_ref = q_ref[n]
        assert code.dtype == torch.int8
        np.testing.assert_array_equal(code.numpy(), np.asarray(code_ref), err_msg=n)
        np.testing.assert_array_equal(scale.numpy(), np.asarray(scale_ref), err_msg=n)
        np.testing.assert_allclose(ef2[n].numpy(), np.asarray(ef2_ref[n]), atol=EF_ATOL, rtol=0)
        deq = compress.decompress_grads(q)[n]
        np.testing.assert_array_equal(
            deq.numpy(), np.asarray(deq_ref[n]), err_msg=n)
        # the error bound and the residual
        g32 = grads[n] + ef[n]
        assert np.abs(deq.numpy() - g32).max() <= float(scale) * 0.5 + 1e-6
        np.testing.assert_allclose(ef2[n].numpy(), g32 - deq.numpy(), atol=1e-6)


def test_layers_of_one_name_share_the_reference_leafs_scale():
    """The reference stacks a name's tensors over the layers into one leaf,
    so they share one scale: the port's per-layer tensors get the same codes."""
    rng = np.random.default_rng(7)
    layers = [rng.standard_normal((6, 5)).astype(np.float32) * (1 + 3 * i) for i in range(3)]
    grads = {f"layers.{i}.mlp.w1": g for i, g in enumerate(layers)}
    grads["embed.head"] = rng.standard_normal((5, 9)).astype(np.float32)
    ef = {n: np.zeros_like(g) for n, g in grads.items()}
    q, ef2 = compress.compress_grads(_torch(grads), _torch(ef))
    stacked = {"layers": {"mlp": {"w1": np.stack(layers)}}, "embed": {"head": grads["embed.head"]}}
    q_ref, ef2_ref = jax.jit(ref_compress.compress_grads)(_jnp(stacked), _jnp(jax.tree.map(
        np.zeros_like, stacked)))
    code_ref, scale_ref = q_ref["layers"]["mlp"]["w1"]
    for i in range(3):
        code, scale = q[f"layers.{i}.mlp.w1"]
        np.testing.assert_array_equal(code.numpy(), np.asarray(code_ref)[i])
        np.testing.assert_array_equal(scale.numpy(), np.asarray(scale_ref))
        np.testing.assert_allclose(ef2[f"layers.{i}.mlp.w1"].numpy(),
                                   np.asarray(ef2_ref["layers"]["mlp"]["w1"])[i],
                                   atol=EF_ATOL, rtol=0)
    np.testing.assert_array_equal(q["embed.head"][0].numpy(),
                                  np.asarray(q_ref["embed"]["head"][0]))
    assert compress.leaf_of("layers.12.attn.wq") == "layers.*.attn.wq"


def test_error_feedback_reinjects():
    g = {"w": torch.full((8, 8), 0.001) + torch.from_numpy(
        np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32))}
    ef, acc, n = compress.ef_init(g), torch.zeros(8, 8), 50
    for _ in range(n):
        deq, ef = compress.roundtrip(g, ef)
        acc += deq["w"]
    np.testing.assert_allclose((acc / n).numpy(), g["w"].numpy(), atol=1e-3)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _batches(n=2, b=4, s=16):
    rng = np.random.default_rng(6)
    out = []
    for _ in range(n):
        toks = rng.integers(0, CFG.vocab_size, (b, s + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :s], "labels": toks[:, 1:]})
    return out


def _model(seed=11):
    return tf.init_params(CFG, torch.Generator().manual_seed(seed), device="cpu",
                          dtype=pdtype(CFG))


def _held(got, want, atol, name, int8=False, bound=None):
    """``got`` within ``atol`` of ``want``; under int8, at least
    ``INT8_AGREE`` of the entries so and, with ``bound``, all within it."""
    if not int8:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=name)
        return
    diff = np.abs(got - want)
    assert np.mean(diff <= atol) >= INT8_AGREE, (name, float(np.mean(diff <= atol)))
    assert bound is None or diff.max() <= bound, (name, float(diff.max()), bound)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _ref_layout(named: dict) -> dict:
    """A dict {parameter name: tensor} in the reference's params layout."""
    model = tf.Transformer(CFG, "cpu", torch.float32)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(named[n])
    return ref_tree(model, CFG)


@pytest.mark.parametrize("micro,comp", [(1, "none"), (2, "none"), (2, "int8")])
def test_make_train_step_matches_reference(micro, comp):
    tcfg = optim.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4,
                             microbatches=micro, grad_compression=comp, eps=STEP_EPS)
    ref_cfg = ref_optim.TrainConfig(**tcfg.__dict__)
    model = _model()
    p_ref = _jnp(ref_tree(model, CFG))
    s_ref = ref_step.init_opt_state(CFG, ref_cfg, p_ref)
    ref_fn = jax.jit(ref_step.make_train_step(CFG, ref_cfg))
    opt = init_opt_state(CFG, tcfg, model)
    assert ("ef" in opt) == (comp == "int8") and opt["step"].device.type == "cpu"
    step = make_train_step(CFG, tcfg)
    int8 = comp == "int8"
    for i, batch in enumerate(_batches()):
        p_ref, s_ref, m_ref = ref_fn(p_ref, s_ref, _jnp(batch))
        model, opt, m = step(model, opt, _torch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), atol=LOSS_ATOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(m_ref["grad_norm"]),
                                   rtol=1e-3 if int8 else 1e-5)
        np.testing.assert_allclose(float(m["lr"]), float(m_ref["lr"]), rtol=1e-6)
        assert int(opt["step"]) == int(s_ref["step"]) == i + 1
        checks = [("params", ref_tree(model, CFG), p_ref, PARAM_ATOL,
                   2 * tcfg.learning_rate * (i + 1)),
                  ("mu", _ref_layout(opt["mu"]), s_ref["mu"], MU_ATOL, None),
                  ("nu", _ref_layout(opt["nu"]), s_ref["nu"], NU_ATOL, None)]
        if int8:
            checks.append(("ef", _ref_layout(opt["ef"]), s_ref["ef"], MU_ATOL, None))
        for kind, got, want, atol, bound in checks:
            want = dict(_leaves(jax.tree.map(np.asarray, want)))
            for path, leaf in _leaves(got):
                _held(leaf, want[path], atol, f"step {i + 1} {kind}/{path}", int8, bound)


def test_microbatches_give_the_same_step():
    batch = _torch(_batches(1, b=8)[0])
    outs = []
    for micro in (1, 2):
        tcfg = optim.TrainConfig(microbatches=micro, total_steps=10, warmup_steps=0)
        model = _model()
        model, _, m = make_train_step(CFG, tcfg)(model, init_opt_state(CFG, tcfg, model), batch)
        outs.append((dict(model.named_parameters()), float(m["loss"])))
    (pa, la), (pb, lb) = outs
    assert abs(la - lb) < 1e-4
    for n in pa:
        np.testing.assert_allclose(pa[n].detach().numpy(), pb[n].detach().numpy(), atol=1e-5,
                                   rtol=0, err_msg=n)


def test_microbatches_must_divide_the_batch():
    tcfg = optim.TrainConfig(microbatches=3)
    model = _model()
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(CFG, tcfg)(model, init_opt_state(CFG, tcfg, model),
                                   _torch(_batches(1, b=4)[0]))
