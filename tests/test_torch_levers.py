"""The single-card levers ``precast_params`` and ``cast_free_attention``
against the JAX package: the sharp checks, where the lever's effect stands
far above the parity tolerance.

* ``cast_free`` in attention, with f32 queries and bf16 keys and values,
  so that the outputs stay f32 and show the lever (P rounded to V's bf16
  before the PV product; the products of bf16 operands exact in f32):
  ``attention.flash_attention`` (training: values and the q, k, v
  gradients against ``jax.grad``), ``ops.flash_prefill`` on the CPU (the
  prefill kernel's plain version) against the reference's
  ``flash_attention``, and ``attn_decode`` of one layer on an f32 stream and
  a bf16 cache, without and with a sliding window, against the reference's
  ``attn_decode`` (outputs and caches). f32 values within atol 1e-5, f32
  gradients within 1e-4 of the largest entry, bf16 gradients within 2 bf16
  ulps; the lever moves the outputs by more than 30 times the tolerance.
* ``precast_params``: on the bf16 SMOKE variants of all four families
  (norm scales and SSM constants drawn from a seed, so that the cast
  rounds them), the tensors ``transformer._precast`` casts equal bit for
  bit the reference's ``_maybe_precast`` of the layer tree and of the
  shared block (every f32 leaf; not the embedding or the final norm), once
  a call; none with the lever off or an f32 compute dtype.
* ``precast_params`` through Zamba2's blocks, whose stream is f32 (a
  Mamba-2 layer, then the shared block): outputs and every master's
  gradient through the cast against ``jax.grad`` of the reference's blocks
  on its precast tree: outputs within atol 1e-5, gradients within 2 bf16
  ulps (a product weight's gradient passes its bf16 cast in both
  packages); the lever moves the outputs by more than 30 times the
  tolerance.

The whole-model checks in bf16 are in ``test_torch_levers_{llama, olmoe,
olmoe_cast_free, rwkv6, zamba2}.py`` (``check_lever`` below).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_att
from repro.models import layers as ref_ly
from repro.models import mamba2 as ref_mamba
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import attention as att
from repro_torch.models import transformer as tf
from repro_torch.models.convert import SHARED_FIELDS, layer_fields, params_from_jax
from test_torch_families import draw_constants
from test_torch_train_forward import one_torch_thread, ref_tree  # noqa: F401 (a fixture)

ARCHS = {"llama": "llama3_2_1b", "olmoe": "olmoe_1b_7b", "rwkv6": "rwkv6_3b",
         "zamba2": "zamba2_1p2b"}
SETTINGS = {"off": {}, "precast": {"precast_params": True},
            "cast_free": {"cast_free_attention": True},
            "both": {"precast_params": True, "cast_free_attention": True}}
ATOL = 1e-5             # f32 outputs of bf16 operands: summation order
GRAD_REL = 1e-4         # f32 gradients, of each tensor's largest entry
BF16_ULPS = 2           # bf16 gradients
EFFECT_OVER_TOL = 30    # the lever's own effect at least this many tolerances


# the hybrid's SMOKE config at 2 layers with the shared block after each (2
# sites, as its 4 layers with a site after every second): the reference
# traces its layer loop, and that tracing bounds these files' time
CUTS = {"zamba2": {"n_layers": 2, "attn_every": 1}}


def variant(family: str, setting: str = "off"):
    """The family's SMOKE config in bf16 with the lever setting."""
    return dataclasses.replace(configs.get_config(ARCHS[family], smoke=True),
                               compute_dtype="bfloat16", **CUTS.get(family, {}),
                               **SETTINGS[setting])


@functools.lru_cache(maxsize=None)
def variant_tree(family: str) -> dict:
    """Weights of the bf16 variant at the reference's shapes and scales (the
    port's seeded f32 init in the reference's layout), norm scales and SSM
    constants drawn from a seed."""
    cfg = variant(family)
    model = tf.init_params(cfg, torch.Generator().manual_seed(21), device="cpu",
                           dtype=torch.float32)
    return draw_constants(ref_tree(model, cfg), seed=22)


def _bf16_close(got: torch.Tensor, want, what: str) -> None:
    """Within BF16_ULPS bf16 ulps of ``want`` (plus an f32 floor)."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= BF16_ULPS * ulp + ATOL), what


# ---------------------------------------------------------------------------
# cast_free in attention
# ---------------------------------------------------------------------------


def _qkv(seed: int, sq: int, g: int, d: int = 16, hkv: int = 2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, g * hkv, d)).astype(np.float32)
    k = rng.standard_normal((2, sq, hkv, d)).astype(np.float32)
    v = rng.standard_normal((2, sq, hkv, d)).astype(np.float32)
    ct = rng.standard_normal((2, sq, g * hkv, d)).astype(np.float32)
    return q, jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), ct


def _torch_bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("g,window", [(1, 0), (4, 5)])
def test_cast_free_flash_attention_values_and_grads(g, window):
    q, k, v, ct = _qkv(g * 10 + window, 24, g)
    kw = dict(causal=True, window=window, q_chunk=8, kv_chunk=16)
    outs = {}
    for cast_free in (False, True):
        def ref_loss(q, k, v):
            out = ref_att.flash_attention(q, k, v, cast_free=cast_free, **kw)
            return jnp.sum(out * ct), out

        (_, want), want_g = jax.jit(jax.value_and_grad(ref_loss, argnums=(0, 1, 2),
                                                       has_aux=True))(q, k, v)
        tq = torch.from_numpy(q).requires_grad_()
        tk, tv = (_torch_bf16(x).requires_grad_() for x in (k, v))
        got = att.flash_attention(tq, tk, tv, cast_free=cast_free, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
        (got * torch.from_numpy(ct)).sum().backward()
        wq = np.asarray(want_g[0])
        np.testing.assert_allclose(tq.grad.numpy(), wq, atol=GRAD_REL * np.abs(wq).max(),
                                   rtol=0, err_msg="dq")
        assert tk.grad.dtype == torch.bfloat16
        _bf16_close(tk.grad, want_g[1], "dk")
        _bf16_close(tv.grad, want_g[2], "dv")
        outs[cast_free] = np.asarray(want)
    assert np.abs(outs[True] - outs[False]).max() > EFFECT_OVER_TOL * ATOL


@pytest.mark.parametrize("g,window", [(1, 0), (4, 5)])
def test_cast_free_prefill_plain_matches_reference(g, window):
    q, k, v, _ = _qkv(g * 10 + window + 1, 40, g)
    outs = {}
    for cast_free in (False, True):
        want = jax.jit(lambda q, k, v, c=cast_free: ref_att.flash_attention(
            q, k, v, window=window, q_chunk=16, kv_chunk=16, cast_free=c))(q, k, v)
        got = ops.flash_prefill(torch.from_numpy(q), _torch_bf16(k), _torch_bf16(v), bq=16,
                                bk=16, window=window, cast_free=cast_free)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        outs[cast_free] = got.numpy()
    assert np.abs(outs[True] - outs[False]).max() > EFFECT_OVER_TOL * ATOL


@pytest.mark.parametrize("window", [0, 5])
def test_cast_free_decode_matches_reference(window):
    """One layer's ``attn_decode`` on an f32 stream (as Zamba2's shared
    block sees) over a bf16 cache, at positions inside and past the window."""
    outs = {}
    for cast_free in (False, True):
        cfg = dataclasses.replace(variant("llama"), cast_free_attention=cast_free,
                                  sliding_window=window)
        tree = variant_tree("llama")
        layer0 = jax.tree.map(lambda a: a[0], tree["layers"]["attn"])
        model = params_from_jax(tree, dataclasses.replace(cfg, sliding_window=0), device="cpu")
        rng = np.random.default_rng(30 + window)
        b, s = 2, 12
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        shape = (b, s, cfg.n_kv_heads, cfg.head_dim)
        ck = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
        cv = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
        pos = np.array([7, 11], np.int32)
        y, (wk, wv) = jax.jit(lambda x, ck, cv, pos, c=cfg: ref_att.attn_decode(
            layer0, x, c, ck, cv, pos))(x, ck, cv, pos)
        tk, tv = _torch_bf16(ck), _torch_bf16(cv)
        with torch.inference_mode():
            got = att.attn_decode(model.layers[0].attn, torch.from_numpy(x), cfg, tk, tv,
                                  torch.from_numpy(pos))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(y), atol=ATOL, rtol=0)
        for name, g_, w_ in (("k", tk, wk), ("v", tv, wv)):
            np.testing.assert_array_equal(g_.float().numpy(), np.asarray(w_, np.float32),
                                          err_msg=name)
        outs[cast_free] = got.numpy()
    assert np.abs(outs[True] - outs[False]).max() > EFFECT_OVER_TOL * ATOL


# ---------------------------------------------------------------------------
# precast_params
# ---------------------------------------------------------------------------


def _f32_bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("family", list(ARCHS))
def test_precast_casts_what_the_reference_casts(family):
    cfg = variant(family, "precast")
    tree = variant_tree(family)
    model = params_from_jax(tree, cfg, device="cpu", dtype=torch.float32)
    casts, shared = tf._casts(model, cfg)
    jtree = jax.tree.map(jnp.asarray, tree)
    want_layers = ref_tf._maybe_precast(jtree["layers"], cfg)
    for i, cast in enumerate(casts):
        fields = layer_fields(cfg)
        assert set(cast) == {f"{blk}.{n}" for blk, names in fields.items() for n in names}
        for blk, names in fields.items():
            for n in names:
                got, want = cast[f"{blk}.{n}"], want_layers[blk][n][i]
                assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, (blk, n)
                np.testing.assert_array_equal(_f32_bits(got.detach().float()),
                                              _f32_bits(want), err_msg=f"{i} {blk}.{n}")
    if family == "zamba2":
        want_shared = ref_tf._maybe_precast(jtree["shared_attn"], cfg)
        assert set(shared) == {f"{blk}.{n}" for blk, names in SHARED_FIELDS.items()
                               for n in names}
        for blk, names in SHARED_FIELDS.items():
            for n in names:
                np.testing.assert_array_equal(_f32_bits(shared[f"{blk}.{n}"].detach().float()),
                                              _f32_bits(want_shared[blk][n]))
    else:
        assert shared is None
    # the embedding and the final norm stay f32 masters: no cast of them
    assert all(not n.startswith(("embed", "final_norm")) for c in casts for n in c)
    # a serving model casts only its f32 weights (norm scales, router, SSM constants)
    serving = params_from_jax(tree, cfg, device="cpu")
    s_casts, _ = tf._casts(serving, cfg)
    f32_names = {n for n, p in serving.layers[0].named_parameters() if p.dtype == torch.float32}
    assert set(s_casts[0]) == f32_names and f32_names
    for off in (variant(family, "off"), dataclasses.replace(cfg, compute_dtype="float32")):
        assert tf._casts(model, off) == ([None] * cfg.n_layers, None)


def test_precast_through_hybrid_blocks_matches_reference():
    """A Mamba-2 layer, then the shared block, on an f32 stream, with the
    weights precast (and, for the effect, without)."""
    tree = variant_tree("zamba2")
    rng = np.random.default_rng(40)
    b, s = 2, 16
    x = rng.standard_normal((b, s, 64)).astype(np.float32)
    ct = rng.standard_normal((b, s, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    outs = {}
    for setting in ("off", "precast"):
        cfg = variant("zamba2", setting)

        def ref_blocks(params):
            lp = jax.tree.map(lambda a: a[0], ref_tf._maybe_precast(params["layers"], cfg))
            sp = ref_tf._maybe_precast(params["shared_attn"], cfg)
            h = x + ref_mamba.ssd_chunked(lp["mamba"], ref_ly.rmsnorm(lp["norm1"], x), cfg,
                                          chunk=tf.SSD_CHUNK)[0]
            h = h + ref_att.attn_forward(sp["attn"], ref_ly.rmsnorm(sp["norm1"], h), cfg, pos)
            h = h + ref_ly.mlp(sp["mlp"], ref_ly.rmsnorm(sp["norm2"], h), cfg)
            return jnp.sum(h * ct), h

        (_, want), want_g = jax.jit(jax.value_and_grad(ref_blocks, has_aux=True))(
            jax.tree.map(jnp.asarray, tree))
        model = params_from_jax(tree, cfg, device="cpu", dtype=torch.float32)
        casts, shared_cast = tf._casts(model, cfg)
        tpos = torch.from_numpy(pos.copy())
        h = tf._call(model.layers[0], casts[0], "train_forward", torch.from_numpy(x), cfg=cfg,
                     positions=tpos)
        h = tf._call(model.shared_attn, shared_cast, "train_forward", h, cfg=cfg,
                     positions=tpos)
        assert h.dtype == torch.float32
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
        (h * torch.from_numpy(ct)).sum().backward()
        want_model = dict(params_from_jax(jax.tree.map(np.asarray, want_g), cfg, device="cpu",
                                          dtype=torch.float32).named_parameters())
        for n, p in model.named_parameters():
            if n.startswith(("layers.0.", "shared_attn.")):
                # a product weight's gradient passes its bf16 cast, in both packages
                _bf16_close(p.grad, want_model[n].detach().numpy(), n)
        outs[setting] = h.detach().numpy()
    assert np.abs(outs["precast"] - outs["off"]).max() > EFFECT_OVER_TOL * ATOL


# ---------------------------------------------------------------------------
# whole-model checks in bf16 (run by test_torch_levers_{family}.py)
# ---------------------------------------------------------------------------

# A whole bf16 model differs from the reference by bf16 rounding flips
# (f32 sums of another order round the other way, and every layer carries
# them on): at 2 x 40 tokens, 2 layers, the levers off, a token's mean
# |logit difference| is typically 0.005-0.017 and the gradients' relative
# L2 difference 0.013-0.153. In the MoE model a flip can also tip a
# near-tied router choice, and that token's logits move by up to 0.5 (and
# the mean loss by up to 0.055): so logits are held by the median over
# tokens of a token's mean |difference|, and the loss loosely. The levers'
# own effect in the reference is of the same order as the flips (0.008-0.038),
# so whole-model parity is held at these bf16 tolerances and the lever's
# effect by its size: the port's change of the logits, lever on against
# off, within EFFECT_BAND of the reference's (exactly none where the
# reference's is none). The sharp checks are above.
MODEL_B, MODEL_S = 4, 16
BF16_LOGIT_TOL = 0.03          # median over tokens of mean |logit difference|
BF16_LOSS_TOL = 0.1
BF16_GRAD_L2_TOL = 0.25        # relative L2 of all gradients together
EFFECT_BAND = (0.5, 2.0)       # the port's lever effect over the reference's


def typical(a: np.ndarray, b: np.ndarray) -> float:
    """The median over tokens (rows) of a token's mean |a - b| over the
    vocabulary."""
    return float(np.median(np.abs(a - b).mean(axis=-1)))


def _model_batch(family: str) -> dict:
    rng = np.random.default_rng(50)
    toks = rng.integers(0, variant(family).vocab_size, (MODEL_B, MODEL_S + 1)).astype(np.int32)
    return {"tokens": toks[:, :MODEL_S], "labels": toks[:, 1:]}


def _named(tree: dict, cfg) -> dict:
    """{port parameter name: array} of a reference-layout tree."""
    model = params_from_jax(tree, cfg, device="cpu", dtype=torch.float32)
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


@functools.lru_cache(maxsize=None)
def reference_run(family: str, setting: str, full: bool) -> dict:
    """The reference's forward logits; with ``full`` also its loss, every
    gradient, and the logits of a prefill and one decode step."""
    cfg, batch = variant(family, setting), _model_batch(family)
    params = jax.tree.map(jnp.asarray, variant_tree(family))
    if not full:
        return {"logits": np.asarray(jax.jit(lambda p: ref_tf.forward(p, batch, cfg)[0])(params))}

    def loss_and_grads(p):
        """``loss_fn`` and its gradient from one trace of the forward: the
        reference's loss of the logits and auxiliary, whose cotangents
        (softmax minus one-hot over the unmasked count; the auxiliary's
        weight) go back through the forward's vjp."""
        (logits, aux), vjp = jax.vjp(lambda q: ref_tf.forward(q, batch, cfg), p)
        labels = batch["labels"]
        mask = (labels >= 0).astype(jnp.float32)
        count = jnp.maximum(mask.sum(), 1.0)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]
        value = jnp.sum(nll * mask) / count + 0.01 * aux.get("moe_aux", 0.0)
        ct = (jnp.exp(logp) - jax.nn.one_hot(labels, logits.shape[-1])) * (mask / count)[..., None]
        return value, logits, vjp((ct, jax.tree.map(lambda a: jnp.full_like(a, 0.01), aux)))[0]

    def serve(p):
        lg, cache = ref_tf.prefill(p, {"tokens": batch["tokens"]}, cfg, MODEL_S + 8)
        return lg, ref_tf.decode_step(p, cache, batch["tokens"][:, :1], cfg)[0]

    value, logits, grads = jax.jit(loss_and_grads)(params)
    prefill, decode = jax.jit(serve)(params)
    return {"logits": np.asarray(logits), "loss": float(value),
            "grads": _named(jax.tree.map(np.asarray, grads), cfg),
            "prefill": np.asarray(prefill), "decode": np.asarray(decode)}


@functools.lru_cache(maxsize=None)
def port_run(family: str, setting: str, full: bool) -> dict:
    """The port's counterpart of ``reference_run``: the trainable model
    for the forward and the gradients, the serving model for prefill and
    decode."""
    cfg, batch = variant(family, setting), _model_batch(family)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = params_from_jax(variant_tree(family), cfg, device="cpu", dtype=torch.float32)
    if not full:
        with torch.no_grad():
            return {"logits": tf.forward(model, tb, cfg)[0].numpy()}
    loss = tf.loss_fn(model, tb, cfg)[0]
    loss.backward()
    with torch.no_grad():
        logits = tf.forward(model, tb, cfg)[0].numpy()
    serving = params_from_jax(variant_tree(family), cfg, device="cpu")
    with torch.inference_mode():
        prefill, cache = tf.prefill(serving, {"tokens": tb["tokens"]}, cfg, MODEL_S + 8)
        decode = tf.decode_step(serving, cache, tb["tokens"][:, :1], cfg)[0]
    return {"logits": logits, "loss": float(loss.detach()),
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()},
            "prefill": prefill.numpy(), "decode": decode.numpy()}


def check_lever(family: str, setting: str, full: bool = True) -> None:
    """The bf16 variant of ``family`` with the lever ``setting`` against the
    reference at the bf16 tolerances above, and the lever's effect on the
    logits against the reference's."""
    got, want = port_run(family, setting, full), reference_run(family, setting, full)
    assert typical(got["logits"], want["logits"]) <= BF16_LOGIT_TOL
    if full:
        assert abs(got["loss"] - want["loss"]) <= BF16_LOSS_TOL
        assert got["grads"].keys() == want["grads"].keys()
        num = sum(float(((got["grads"][n] - w) ** 2).sum()) for n, w in want["grads"].items())
        den = sum(float((w ** 2).sum()) for w in want["grads"].values())
        assert np.sqrt(num / den) <= BF16_GRAD_L2_TOL, np.sqrt(num / den)
        for key in ("prefill", "decode"):
            assert typical(got[key], want[key]) <= BF16_LOGIT_TOL, key
    if setting == "off":
        return
    port_effect = typical(got["logits"], port_run(family, "off", False)["logits"])
    ref_effect = typical(want["logits"], reference_run(family, "off", False)["logits"])
    if ref_effect == 0:   # the lever changes nothing there (no attention, or f32 attention)
        assert port_effect == 0
    else:
        assert EFFECT_BAND[0] <= port_effect / ref_effect <= EFFECT_BAND[1], \
            (port_effect, ref_effect)
