"""The serving path of the SSM (RWKV-6) and hybrid (Mamba-2 + shared
attention) families against the JAX package, at the rwkv6 and zamba2 SMOKE
configs, with ``test_torch_families.py``'s weights (norm scales and SSM
constants drawn from a seed). f32.

* ``prefill`` of ragged prompts (``lengths``) and three ``decode_step``
  calls: logits (atol 1e-4, as the forward's) and every cache field (1e-4),
  dtypes and shapes equal to the reference's (the hybrid's conv states and
  K and V in f32, as the reference's prefill returns them).
* ``serve_batch`` on ragged prompts: the generated tokens, the first of
  each request included, equal to the reference's ``serve_batch``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as ref_serve
from repro.models import transformer as ref_tf
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from test_torch_families import CACHE_ATOL, CFGS, LOGIT_ATOL, NAMES, S, _batch, _tree
from test_torch_train_forward import one_torch_thread  # noqa: F401 (a fixture)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_reference(name):
    cfg = CFGS[name]
    tree = _tree(name)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = params_from_jax(tree, cfg, device="cpu")
    toks = _batch(name, seed=3)["tokens"]
    lengths = np.array([S, S - 9], np.int32)
    want_lg, want_cache = jax.jit(lambda p, b: ref_tf.prefill(p, b, cfg, cache_len=64))(
        jparams, {"tokens": toks, "lengths": lengths})
    ref_decode = jax.jit(lambda p, c, t: ref_tf.decode_step(p, c, t, cfg))
    with torch.inference_mode():
        got_lg, cache = tf.prefill(model, {"tokens": torch.from_numpy(toks),
                                           "lengths": torch.from_numpy(lengths)}, cfg, 64)
    steps = [(got_lg, want_lg, {k: v.clone() for k, v in cache.items()}, want_cache)]
    for t in range(3):
        nxt = toks[:, t:t + 1]
        want_lg, want_cache = ref_decode(jparams, want_cache, nxt)
        with torch.inference_mode():
            got_lg, cache = tf.decode_step(model, cache, torch.from_numpy(nxt), cfg)
        steps.append((got_lg, want_lg, {k: v.clone() for k, v in cache.items()}, want_cache))
    for i, (g_lg, w_lg, g_cache, w_cache) in enumerate(steps):
        np.testing.assert_allclose(g_lg.numpy(), np.asarray(w_lg), atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"logits {i}")
        assert g_cache.keys() == w_cache.keys()
        for k, w in w_cache.items():
            g = g_cache[k]
            assert tuple(g.shape) == w.shape and str(g.dtype).endswith(str(w.dtype)), k
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=CACHE_ATOL, rtol=0,
                                       err_msg=f"cache {k} {i}")


@pytest.mark.parametrize("name", NAMES)
def test_serve_batch_matches_reference(name):
    cfg = CFGS[name]
    tree = _tree(name)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (5, 12, 8, 3)]
    want, _ = ref_serve.serve_batch(cfg, prompts, max_new_tokens=5, cache_len=32,
                                    params=jax.tree.map(jnp.asarray, tree))
    got, stats = serve.serve_batch(cfg, prompts, max_new_tokens=5, cache_len=32,
                                   params=params_from_jax(tree, cfg, device="cpu"),
                                   device="cpu")
    assert [o[0] for o in got] == [o[0] for o in want]
    assert got == want
    assert stats.generated_tokens == 20
