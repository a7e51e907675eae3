"""The SSM (RWKV-6) and hybrid (Mamba-2 + shared attention) families of the
port against the JAX package, at the rwkv6 and zamba2 SMOKE configs.

The weights (the port's seeded init at the reference's shapes and scales,
in the reference's layout, its norm scales and SSM constants then drawn
from a seed, so that none sits at a value that hides a mix-up) go into
the reference as its params tree and into the port through
``params_from_jax``. Batches of 2 x 40
tokens: 40 leaves a padded tail in both chunked forms (RWKV chunks of 32,
SSD chunks of 64). f32 throughout (the SMOKE configs compute in f32).

* ``forward`` logits (atol 1e-4), ``loss_fn`` (1e-5) and the gradient of
  every parameter against ``jax.grad`` of the reference's ``loss_fn``, by
  name (the reference's gradient tree carried across with
  ``params_from_jax``; the hybrid's shared block once, its gradient summed
  over its sites), each within 5e-5 of its tensor's largest entry; every
  parameter gets a nonzero gradient. f32 summation order, which the
  reference's RWKV chunked form scales: it divides keys by in-chunk
  cumulative decays (up to e^53 with ``w0`` drawn up to 0.5); measured up
  to 1.5e-5 (both families), logits 5.5e-5 (RWKV) and 1.1e-5 (Zamba2).
* ``_remat``: policies ``"full"`` and ``"dots"`` and ``remat=False`` give
  the same gradients (atol 1e-6); the training forward calls no kernel
  wrapper.
* Decode matches forward, as the reference's ``test_decode_matches_forward``:
  the prefill of 36 tokens and 4 decode steps against ``forward`` on all
  40 (max error under 2e-2; here within 1e-4).
* ``params_from_jax`` refuses a layer or shared-block array of another
  shape, naming it.

The serving path's parity (prefill, decode, ``serve_batch``) is in
``test_torch_families_serve.py``.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from test_torch_train_forward import one_torch_thread, ref_tree  # noqa: F401 (a fixture)

CFGS = {"rwkv6": configs.get_config("rwkv6_3b", smoke=True),
        "zamba2": configs.get_config("zamba2_1p2b", smoke=True)}
NAMES = list(CFGS)
B, S = 2, 40
LOGIT_ATOL, LOSS_ATOL, CACHE_ATOL = 1e-4, 1e-5, 1e-4
GRAD_REL = 5e-5      # of each gradient tensor's largest entry
REMAT_ATOL = 1e-6
DECODE_FORWARD_TOL = 2e-2   # the reference test's bound
# the constants drawn from a seed: (low, high) by leaf name
DRAWN = {"scale": (0.5, 1.5), "w0": (-1.5, 0.5), "ln_x": (0.5, 1.5), "mix_mu": (0.1, 0.9),
         "cm_mu_k": (0.1, 0.9), "cm_mu_r": (0.1, 0.9), "A_log": (-1.0, 2.0),
         "dt_bias": (-3.0, 0.0), "D": (0.5, 1.5), "norm_scale": (0.5, 1.5),
         "conv_b": (-0.2, 0.2)}


def draw_constants(tree: dict, seed: int) -> dict:
    """``tree`` (nested dicts of arrays) with the leaves named in ``DRAWN``
    redrawn uniformly from a seed."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for key, value in node.items():
            if isinstance(value, dict):
                out[key] = walk(value)
            elif key in DRAWN:
                out[key] = rng.uniform(*DRAWN[key], np.shape(value)).astype(np.float32)
            else:
                out[key] = np.asarray(value)
        return out
    return walk(tree)


@functools.lru_cache(maxsize=None)
def _tree(name: str) -> dict:
    """Weights at the reference's shapes and scales (the port's seeded f32
    init in the reference's layout), constants drawn from a seed."""
    cfg = CFGS[name]
    model = tf.init_params(cfg, torch.Generator().manual_seed(11), device="cpu",
                           dtype=torch.float32)
    return draw_constants(ref_tree(model, cfg), seed=12)


def _batch(name: str, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFGS[name].vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -3:] = -1
    return {"tokens": toks[:, :S], "labels": labels}


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(name: str):
    cfg, batch = CFGS[name], jax.tree.map(jnp.asarray, _batch(name))

    def f(p):
        loss, metrics = ref_tf.loss_fn(p, batch, cfg)
        return loss, (metrics, ref_tf.forward(p, batch, cfg)[0])

    return jax.jit(jax.value_and_grad(f, has_aux=True))(jax.tree.map(jnp.asarray, _tree(name)))


def _train_model(name: str, cfg=None):
    return params_from_jax(_tree(name), cfg or CFGS[name], device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("name", NAMES)
def test_forward_loss_and_every_gradient_match_reference(name):
    cfg = CFGS[name]
    (want_loss, (want_m, want_logits)), want_g = _ref_value_and_grad(name)
    model = _train_model(name)
    with torch.no_grad():
        logits, aux = tf.forward(model, _torch_batch(_batch(name)), cfg)
    assert logits.dtype == torch.float32 and logits.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=LOGIT_ATOL, rtol=0)
    assert float(aux["moe_aux"]) == 0.0
    loss, metrics = tf.loss_fn(model, _torch_batch(_batch(name)), cfg)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(float(metrics["loss"]), float(want_m["loss"]), atol=LOSS_ATOL,
                               rtol=0)
    loss.backward()
    want = dict(params_from_jax(jax.tree.map(np.asarray, want_g), cfg, device="cpu",
                                dtype=torch.float32).named_parameters())
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    assert any(n.startswith("shared_attn.") for n in got) == (name == "zamba2")
    for n, p in got.items():
        assert p.grad is not None and bool(torch.any(p.grad != 0)), n
        w = want[n].detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=GRAD_REL * float(np.abs(w).max()),
                                   rtol=0, err_msg=n)


@pytest.mark.parametrize("name", NAMES)
def test_remat_policies_agree_and_no_kernel_wrapper_runs(name):
    batch = _torch_batch(_batch(name, seed=2))
    grads = {}
    banned = ("flash_prefill", "decode_attention", "grouped_matmul", "grouped_matmul_ragged")
    for label, remat, policy in (("off", False, "full"), ("full", True, "full"),
                                 ("dots", True, "dots")):
        cfg = dataclasses.replace(CFGS[name], remat=remat, remat_policy=policy)
        model = _train_model(name, cfg)
        with mock.patch.multiple(ops, **{n: mock.DEFAULT for n in banned}) as spies:
            tf.loss_fn(model, batch, cfg)[0].backward()
        assert not any(spy.called for spy in spies.values())
        grads[label] = {n: p.grad.clone() for n, p in model.named_parameters()}
    for label in ("full", "dots"):
        for n, g in grads["off"].items():
            np.testing.assert_allclose(grads[label][n].numpy(), g.numpy(), atol=REMAT_ATOL,
                                       rtol=0, err_msg=f"{label}: {n}")


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_forward(name):
    cfg = CFGS[name]
    model = params_from_jax(_tree(name), cfg, device="cpu")
    toks = torch.from_numpy(_batch(name, seed=4)["tokens"])
    n_pre = S - 4
    with torch.inference_mode():
        logits, _ = tf.forward(model, {"tokens": toks}, cfg)
        lg, cache = tf.prefill(model, {"tokens": toks[:, :n_pre]}, cfg, S)
        errs = [float((lg - logits[:, n_pre - 1]).abs().max())]
        for t in range(n_pre, S):
            lg, cache = tf.decode_step(model, cache, toks[:, t:t + 1], cfg)
            errs.append(float((lg - logits[:, t]).abs().max()))
    assert max(errs) < DECODE_FORWARD_TOL and max(errs) < LOGIT_ATOL, errs


@pytest.mark.parametrize("name,path", [
    ("rwkv6", ("layers", "rwkv", "wr")), ("rwkv6", ("layers", "rwkv", "u")),
    ("zamba2", ("layers", "mamba", "in_proj")), ("zamba2", ("layers", "mamba", "A_log")),
    ("zamba2", ("shared_attn", "attn", "wq")), ("zamba2", ("shared_attn", "mlp", "w2"))])
def test_params_from_jax_refuses_wrong_shapes(name, path):
    tree = jax.tree.map(np.copy, _tree(name))
    node = tree
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = np.zeros(node[path[-1]].shape[:-1] + (node[path[-1]].shape[-1] + 1,),
                              np.float32)
    with pytest.raises(ValueError, match="/".join(path)):
        params_from_jax(tree, CFGS[name], device="cpu")
