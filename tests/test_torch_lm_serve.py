"""The port's dense LM serving path against the JAX package.

* Configs: every ported CONFIG and SMOKE equals the reference's field for
  field, parameter counts included; an unported arch raises and names
  ROADMAP.
* Model: the llama SMOKE config (float32 compute) with the reference's
  ``tf.init_params`` weights carried across by ``params_from_jax``: prefill
  logits and the K/V cache against ``tf.prefill`` (uneven prompts with
  ``lengths``), several ``decode_step``s against the reference's, a sliding
  window config through its ring buffer, and ``serve_batch`` ids equal to
  the reference's ``serve_batch`` (atol 1e-4 on logits: summation order only).
* ``init_params``: the reference's shapes and scales, reproducible from a
  seeded generator.
* Refusals: the card entry points refuse a CPU-only host unless
  ``device="cpu"``; unported families and frontends raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import serve as ref_serve
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import attention as att
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.train.step import make_prefill, make_serve_step

ATOL = 1e-4          # f32 compute, summation order only
KEY = jax.random.PRNGKey(0)
CFG = configs.get_config("llama3.2-1b", smoke=True)


def _jax_params(cfg):
    return ref_tf.init_params(KEY, cfg)


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def _prompts(rng, cfg, lens):
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in lens]


def _padded(prompts):
    toks = np.zeros((len(prompts), max(len(p) for p in prompts)), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    return toks


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.PORTED)
def test_configs_equal_reference_field_for_field(arch):
    for smoke in (False, True):
        port, want = configs.get_config(arch, smoke), ref_configs.get_config(arch, smoke)
        assert dataclasses.asdict(port) == dataclasses.asdict(want), (arch, smoke)
        assert port.param_count() == want.param_count()
        assert port.active_param_count() == want.active_param_count()
        assert port.q_per_kv == want.q_per_kv and port.has_attention == want.has_attention
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS and configs.ALIASES == ref_configs.ALIASES
    for alias, arch_id in configs.ALIASES.items():
        assert configs.canonical(alias) == ref_configs.canonical(alias) == arch_id


def test_get_config_refuses_unported_and_unknown_archs():
    with pytest.raises(ValueError, match="ROADMAP"):
        configs.get_config("rwkv6-3b")
    with pytest.raises(ValueError, match="unknown arch"):
        configs.get_config("gpt-17")
    # llama3.2-1b at full width: about 1.50 B parameters with an untied head
    assert abs(configs.get_config("llama3.2-1b").param_count() - 1.498e9) < 1e7


# ---------------------------------------------------------------------------
# model parity
# ---------------------------------------------------------------------------


def test_init_params_shapes_scales_and_seed():
    gen = torch.Generator().manual_seed(3)
    model = tf.init_params(CFG, gen, device="cpu")
    want = jax.eval_shape(lambda k: ref_tf.init_params(k, CFG), KEY)
    layer0 = model.layers[0]
    assert tuple(model.embed.embedding.shape) == want["embed"]["embedding"].shape
    assert tuple(model.embed.head.shape) == want["embed"]["head"].shape
    for block, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("w1", "w3", "w2"))):
        for name in names:
            assert (CFG.n_layers, *getattr(getattr(layer0, block), name).shape) == \
                want["layers"][block][name].shape, (block, name)
    d, h, hd = CFG.d_model, CFG.n_heads, CFG.head_dim
    for w, scale in ((layer0.attn.wq, d ** -0.5), (layer0.attn.wo, (h * hd) ** -0.5),
                     (layer0.mlp.w2, CFG.d_ff ** -0.5), (model.embed.head, d ** -0.5)):
        assert abs(float(w.std()) / scale - 1) < 0.1
    assert torch.equal(layer0.norm1.scale, torch.ones(d))
    again = tf.init_params(CFG, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize("window", [0, 8])
def test_prefill_and_decode_match_reference(rng, window):
    cfg = dataclasses.replace(CFG, sliding_window=window)
    jparams = _jax_params(cfg)
    model = params_from_jax(_numpy_tree(jparams), cfg, device="cpu")
    prompts = _prompts(rng, cfg, [9, 21, 14])
    toks, lens = _padded(prompts), np.array([9, 21, 14], np.int32)
    cache_len = 32
    want, jcache = ref_tf.prefill(jparams, {"tokens": jnp.asarray(toks),
                                            "lengths": jnp.asarray(lens)}, cfg, cache_len)
    with torch.inference_mode():
        got, cache = make_prefill(cfg, cache_len)(
            model, {"tokens": torch.from_numpy(toks), "lengths": torch.from_numpy(lens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), atol=ATOL,
                                   rtol=0)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    step = jnp.argmax(want, axis=-1).astype(jnp.int32)[:, None]
    for _ in range(4):
        want, jcache = ref_tf.decode_step(jparams, jcache, step, cfg)
        with torch.inference_mode():
            got, cache = tf.decode_step(model, cache, torch.from_numpy(np.asarray(step)), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        step = jnp.argmax(want, axis=-1).astype(jnp.int32)[:, None]
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), atol=ATOL,
                                   rtol=0)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_serve_step_is_greedy_argmax(rng):
    model = tf.init_params(CFG, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.from_numpy(_padded(_prompts(rng, CFG, [6, 6])))
    with torch.inference_mode():
        _, cache = tf.prefill(model, {"tokens": toks}, CFG, 16)
        pos = cache["pos"].clone()
        nxt, cache = make_serve_step(CFG)(model, cache, toks[:, -1:])
    assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
    assert torch.equal(cache["pos"], pos + 1)


def test_serve_batch_matches_reference(rng):
    jparams = _jax_params(CFG)
    model = params_from_jax(_numpy_tree(jparams), CFG, device="cpu")
    prompts = [p.tolist() for p in _prompts(rng, CFG, [5, 12, 8, 3])]
    want, _ = ref_serve.serve_batch(CFG, prompts, max_new_tokens=6, cache_len=32,
                                    params=jparams)
    got, stats = serve.serve_batch(CFG, prompts, max_new_tokens=6, cache_len=32,
                                   params=model, device="cpu")
    assert got == want
    assert stats.prompts == 4 and stats.generated_tokens == 24 and stats.tokens_per_s > 0
    # an opt-in EOS stops each sequence at its first EOS
    eos = want[0][1]
    got_eos, _ = serve.serve_batch(CFG, prompts, max_new_tokens=6, cache_len=32,
                                   params=model, device="cpu", eos_id=eos)
    for out, full in zip(got_eos, want):
        cut = full.index(eos) + 1 if eos in full else len(full)
        assert out == full[:cut]


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--batch", "2",
                "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert out.count("[serve] seq") == 2 and "tok/s decode" in out


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_card_entry_points_refuse_a_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the refusal is for CPU-only hosts")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_batch(CFG, [[1, 2, 3]], max_new_tokens=2, cache_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.init_params(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.init_cache(CFG, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "llama3.2-1b", "--smoke"])


def test_serve_batch_refuses_a_cache_too_short():
    model = tf.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="cache_len"):
        serve.serve_batch(CFG, [[1] * 10], max_new_tokens=8, cache_len=16, params=model,
                          device="cpu")


def test_window_decode_refuses_the_card():
    """Sliding-window decode off the CPU raises rather than running the plain
    ring-buffer path (meta tensors stand in for the card's)."""
    cfg = dataclasses.replace(CFG, sliding_window=8)
    model = tf.Transformer(cfg, device="meta")
    cache = {k: v.to("meta") for k, v in tf.init_cache(cfg, 2, 8, device="cpu").items()}
    x = torch.zeros(2, 1, cfg.d_model, device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        att.attn_decode(model.layers[0].attn, x, cfg, cache["k"][0], cache["v"][0],
                        cache["pos"])


@pytest.mark.parametrize("kw", [
    {"family": "ssm", "ssm_family": "rwkv6"},
    {"family": "hybrid", "ssm_family": "mamba2", "ssm_state": 8, "attn_every": 2},
    {"frontend": "vision_stub"},
], ids=["ssm", "hybrid", "frontend"])
def test_unported_families_raise(kw):
    cfg = ModelConfig(**{**dataclasses.asdict(CFG), **kw})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.Transformer(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.init_cache(cfg, 1, 8, device="cpu")
