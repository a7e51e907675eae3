"""The port's differentiable training forward against the JAX package.

* ``attention.flash_attention`` (the reference's doubly chunked online
  softmax, ported as its own body) against ``repro.models.attention.
  flash_attention``: values, and the gradients of q, k and v of a seeded
  cotangent against ``jax.grad``; windows 0 and 5, GQA groups 1 and 4,
  ragged tails (sequence lengths that no chunk divides) and several chunk
  sizes. f32, atol 1e-5 on values and 1e-4 on gradients (summation order
  only; the gradients sum over up to 64 positions).
* ``transformer.forward`` on the llama and OLMoE SMOKE configs in f32 with
  the reference's weights carried across (``params_from_jax(...,
  dtype=torch.float32)``): logits and ``moe_aux`` against ``ref_tf.forward``
  (atol 1e-4 on logits, 1e-6 on the auxiliary).
* ``transformer.loss_fn``: the loss and the gradient of every parameter
  against ``jax.grad`` of the reference's, by name (the reference's
  gradient tree carried across with ``params_from_jax``), atol 1e-5.
* ``_remat``: policies ``"full"`` and ``"dots"`` and ``remat=False`` give
  the same gradients (atol 1e-6).
* The training forward runs no kernel wrapper, and ``loss.backward()``
  leaves a nonzero gradient on every parameter, attention and experts
  included; each of the four LM kernel wrappers raises on an input that
  requires grad under grad mode and runs under ``torch.no_grad()``.
* ``init_params(..., dtype=pdtype(cfg))``: trainable f32 masters that,
  cast to bf16, equal the serving model from the same seed bit for bit;
  the default stays the serving model. The reference's levers raise.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_att
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import attention as att
from repro_torch.models import transformer as tf
from repro_torch.models.convert import _FFN_FIELDS, _LAYER_FIELDS, params_from_jax
from repro_torch.models.layers import pdtype

ATOL = 1e-5          # f32 attention values, summation order only
GRAD_ATOL = 1e-4     # f32 attention gradients (sums over up to 64 positions)
LOGIT_ATOL = 1e-4    # f32 logits of the SMOKE models
AUX_ATOL = 1e-6
PARAM_GRAD_ATOL = 1e-5
REMAT_ATOL = 1e-6
LLAMA = configs.get_config("llama3.2-1b", smoke=True)
OLMOE = configs.get_config("olmoe-1b-7b", smoke=True)
CFGS = {"llama": LLAMA, "olmoe": OLMOE}
B, S = 2, 24          # S = 24: a ragged tail on the SMOKE configs' 16-chunks


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny models run on one torch thread: the suite runs files in
    parallel workers, where every worker's thread pool would share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ref_tree(model, cfg) -> dict:
    """The reference's params tree of the port's model (layers stacked on a
    leading axis), as NumPy arrays: the inverse of ``params_from_jax``."""
    def a(t):
        return t.detach().numpy().copy()

    fields = {**_LAYER_FIELDS, **_FFN_FIELDS[cfg.family]}
    layers = {block: {n: np.stack([a(getattr(getattr(layer, block), n))
                                   for layer in model.layers]) for n in names}
              for block, names in fields.items()}
    return {"embed": {"embedding": a(model.embed.embedding), "head": a(model.embed.head)},
            "layers": layers, "final_norm": {"scale": a(model.final_norm.scale)}}


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    """The reference's weights: the port's seeded f32 masters (norm scales
    drawn too, so that their gradients are not all at one), as jnp."""
    cfg = CFGS[name]
    model = tf.init_params(cfg, torch.Generator().manual_seed(11), device="cpu",
                           dtype=pdtype(cfg))
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("scale"):
                p.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(len(n)))
    return jax.tree.map(jnp.asarray, ref_tree(model, cfg))


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(name):
    """((loss, (metrics, (logits, aux))), parameter gradients) of the
    reference on ``_batch(name)``, from one jitted call."""
    cfg, batch = CFGS[name], jax.tree.map(jnp.asarray, _batch(name))

    def f(p):
        loss, metrics = ref_tf.loss_fn(p, batch, cfg)
        return loss, (metrics, ref_tf.forward(p, batch, cfg))

    return jax.jit(jax.value_and_grad(f, has_aux=True))(_jax_params(name))


def _model(name):
    return params_from_jax(_numpy_tree(_jax_params(name)), CFGS[name], device="cpu",
                           dtype=torch.float32)


def _batch(name, seed=0):
    rng = np.random.default_rng(seed)
    v = CFGS[name].vocab_size
    toks = rng.integers(0, v, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -3:] = -1                     # masked positions
    return {"tokens": toks[:, :S], "labels": labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# flash attention: values and gradients
# ---------------------------------------------------------------------------


# (sequence, q chunk, kv chunk, GQA group, window): both windows at both
# groups, tails that no chunk divides (23, 37, 20) and Q chunks smaller,
# equal to and larger than the KV chunks
ATTN_CASES = [(32, 16, 16, 4, 0), (23, 8, 16, 4, 5), (37, 16, 8, 1, 5), (20, 32, 32, 1, 0)]


@pytest.mark.parametrize("sq,q_chunk,kv_chunk,g,window", ATTN_CASES)
def test_flash_attention_values_and_grads_match_reference(sq, q_chunk, kv_chunk, g, window):
    rng = np.random.default_rng(sq * 100 + g * 10 + window)
    b, hkv, d = 2, 2, 16
    q = rng.standard_normal((b, sq, g * hkv, d)).astype(np.float32)
    k = rng.standard_normal((b, sq, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sq, hkv, d)).astype(np.float32)
    ct = rng.standard_normal((b, sq, g * hkv, d)).astype(np.float32)
    kw = dict(causal=True, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)

    def ref_loss(q, k, v):
        out = ref_att.flash_attention(q, k, v, **kw)
        return jnp.sum(out * ct), out

    (_, want), want_g = jax.jit(jax.value_and_grad(ref_loss, argnums=(0, 1, 2),
                                                   has_aux=True))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = np.asarray(want)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = att.flash_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=0)
    (got * torch.from_numpy(ct)).sum().backward()
    for name, t, w in zip("qkv", (tq, tk, tv), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"d{name}")


def test_flash_attention_refuses_cast_free():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        att.flash_attention(x, x, x, cast_free=True)


# ---------------------------------------------------------------------------
# forward, loss and every parameter's gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama", "olmoe"])
def test_forward_matches_reference(name):
    cfg, batch = CFGS[name], _batch(name)
    (_, (_, (want_logits, want_aux))), _ = _ref_value_and_grad(name)
    with torch.no_grad():
        logits, aux = tf.forward(_model(name), _torch_batch(batch), cfg)
    assert logits.dtype == torch.float32 and logits.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(aux["moe_aux"]), float(want_aux["moe_aux"]),
                               atol=AUX_ATOL, rtol=0)
    if name == "olmoe":
        assert float(aux["moe_aux"]) > 0


@pytest.mark.parametrize("name", ["llama", "olmoe"])
def test_loss_and_every_parameter_gradient_match_reference(name):
    cfg, batch = CFGS[name], _batch(name)
    (want_loss, (want_m, _)), want_g = _ref_value_and_grad(name)
    model = _model(name)
    loss, metrics = tf.loss_fn(model, _torch_batch(batch), cfg)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(metrics["loss"]), float(want_m["loss"]), atol=1e-5,
                               rtol=0)
    loss.backward()
    # the reference's gradient tree, carried across by name
    want = dict(params_from_jax(_numpy_tree(want_g), cfg, device="cpu",
                                dtype=torch.float32).named_parameters())
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    for n, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[n].detach().numpy(),
                                   atol=PARAM_GRAD_ATOL, rtol=0, err_msg=n)


@pytest.mark.parametrize("name", ["llama", "olmoe"])
def test_remat_policies_give_the_same_gradients(name):
    batch = _torch_batch(_batch(name, seed=2))
    grads = {}
    for label, remat, policy in (("off", False, "full"), ("full", True, "full"),
                                 ("dots", True, "dots")):
        cfg = dataclasses.replace(CFGS[name], remat=remat, remat_policy=policy)
        model = _model(name)
        tf.loss_fn(model, batch, cfg)[0].backward()
        grads[label] = {n: p.grad.clone() for n, p in model.named_parameters()}
    for label in ("full", "dots"):
        for n, g in grads["off"].items():
            np.testing.assert_allclose(grads[label][n].numpy(), g.numpy(),
                                       atol=REMAT_ATOL, rtol=0, err_msg=f"{label}: {n}")


def test_dots_policy_saves_only_products_without_batch_dims():
    """The "dots" policy keeps aten.mm outputs (no batch dims) and nothing else."""
    from torch.utils.checkpoint import CheckpointPolicy

    must = tf._save_mm(None, torch.ops.aten.mm.default)
    assert must == CheckpointPolicy.MUST_SAVE
    for func in (torch.ops.aten.bmm.default, torch.ops.aten.exp.default,
                 torch.ops.aten.add.Tensor):
        assert tf._save_mm(None, func) == CheckpointPolicy.PREFER_RECOMPUTE
    with pytest.raises(ValueError, match="remat_policy"):
        tf._remat(lambda x: x, dataclasses.replace(LLAMA, remat_policy="some"))


@pytest.mark.parametrize("name", ["llama", "olmoe"])
def test_training_forward_runs_no_kernel_wrapper_and_every_parameter_learns(name):
    cfg, batch = CFGS[name], _torch_batch(_batch(name, seed=3))
    model = tf.init_params(cfg, torch.Generator().manual_seed(5), device="cpu",
                           dtype=pdtype(cfg))
    banned = ("grouped_matmul", "grouped_matmul_ragged", "decode_attention", "flash_prefill")
    with contextlib_exit_stack(banned) as calls:
        loss, _ = tf.loss_fn(model, batch, cfg)
        loss.backward()
    assert not calls, calls
    for n, p in model.named_parameters():
        assert p.requires_grad and p.dtype == torch.float32, n
        assert p.grad is not None and bool(torch.any(p.grad != 0)), n
    if name == "olmoe":
        assert any(".moe.w2" in n for n, _ in model.named_parameters())


class contextlib_exit_stack:
    """Patches each named ops wrapper to record its calls."""

    def __init__(self, names):
        self.names, self.calls, self.patches = names, [], []

    def __enter__(self):
        for n in self.names:
            p = mock.patch.object(ops, n, side_effect=lambda *a, _n=n, **k:
                                  self.calls.append(_n))
            p.start()
            self.patches.append(p)
        return self.calls

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()


def _wrapper_calls():
    """Each LM wrapper with small valid CPU inputs (fresh tensors each call)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    return {
        "flash_prefill": lambda f: ops.flash_prefill(f(r(1, 16, 4, 8)), r(1, 16, 2, 8),
                                                     r(1, 16, 2, 8), bq=8, bk=8),
        "decode_attention": lambda f: ops.decode_attention(
            r(2, 2, 2, 8), f(r(2, 16, 2, 8)), r(2, 16, 2, 8), torch.tensor([3, 16])),
        "grouped_matmul": lambda f: ops.grouped_matmul(r(12, 8), f(r(2, 8, 16)), [5, 7],
                                                       bt=8, bn=16, bk=8),
        "grouped_matmul_ragged": lambda f: ops.grouped_matmul_ragged(
            f(r(12, 8)), r(2, 8, 16), torch.tensor([0, 5, 12])),
    }


@pytest.mark.parametrize("wrapper", ["flash_prefill", "decode_attention", "grouped_matmul",
                                     "grouped_matmul_ragged"])
def test_kernel_wrappers_refuse_autograd(wrapper):
    call = _wrapper_calls()[wrapper]
    with pytest.raises(RuntimeError, match="transformer.forward"):
        call(lambda t: t.requires_grad_())
    with torch.no_grad():
        call(lambda t: t.requires_grad_())
    call(lambda t: t)


# ---------------------------------------------------------------------------
# the trainable model, the levers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama", "olmoe"])
def test_trainable_masters_cast_equal_the_serving_model(name):
    cfg = dataclasses.replace(CFGS[name], compute_dtype="bfloat16")
    serve = tf.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    train = tf.init_params(cfg, torch.Generator().manual_seed(7), device="cpu",
                           dtype=pdtype(cfg))
    s_params, t_params = dict(serve.named_parameters()), dict(train.named_parameters())
    assert s_params.keys() == t_params.keys()
    for n, p in t_params.items():
        assert p.dtype == torch.float32 and p.requires_grad, n
        q = s_params[n]
        assert not q.requires_grad, n
        assert torch.equal(p.detach().to(q.dtype), q), n
    assert serve.embed.head.dtype == torch.bfloat16
    assert serve.layers[0].norm1.scale.dtype == torch.float32


@pytest.mark.parametrize("lever,value", [("precast_params", True),
                                         ("cast_free_attention", True),
                                         ("shard_activations", True),
                                         ("dp_axes", ("data",)), ("tp_axis", "model")])
def test_levers_raise(lever, value):
    cfg = dataclasses.replace(LLAMA, **{lever: value})
    model = tf.init_params(LLAMA, torch.Generator().manual_seed(0), device="cpu",
                           dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.forward(model, _torch_batch(_batch("llama")), cfg)
