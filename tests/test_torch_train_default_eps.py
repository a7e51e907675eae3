"""One ``make_train_step`` step against the JAX package's at AdamW's
default eps (1e-8), on the llama and rwkv6 SMOKE configs (f32; zamba2's in
``test_torch_train_default_eps_hybrid.py``), from
the same weights (the port's seeded init in the reference's layout, norm
scales and SSM constants drawn from a seed) and batch.

At step 1 AdamW moves a parameter by ``lr * g / (|g| + eps)``: with eps
1e-8 a gradient within f32 summation order of zero can take either sign,
and its parameter can land up to 2 lr from the reference's. So, as the card
check ``train_card_vs_cpu`` holds the card to the CPU: every parameter
within 1e-6 of the reference's, except where the reference's gradient lies
within 1e-5 of zero, and those within 2 lr + 1e-6. The reference's gradient
is its first moment over (1 - beta1). The loss within 1e-5, ``grad_norm``
within rtol 1e-4 and ``mu`` within 1e-5 of the largest moment (RWKV's
gradients differ from the reference's by up to 5e-5 of a tensor's
largest), ``nu`` within what the gradients' differences allow, (1 -
beta2)(2 max|g| dg + dg^2) with dg the largest gradient difference the
moments show.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optim as ref_optim
from repro.train import step as ref_step
from repro_torch import configs
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.train import optim
from repro_torch.train.step import init_opt_state, make_train_step
from test_torch_families import draw_constants
from test_torch_train_forward import one_torch_thread, ref_tree  # noqa: F401 (a fixture)

ARCHS = ("llama3_2_1b", "rwkv6_3b")   # zamba2: test_torch_train_default_eps_hybrid.py
LR = 1e-3
PARAM_ATOL, HAZARD_GRAD, LOSS_ATOL = 1e-6, 1e-5, 1e-5
# gradients differ from the reference's by f32 summation order, up to 5e-5
# of a tensor's largest entry for RWKV (the reference's factored in-chunk
# decays scale its rounding; test_torch_families.py): the global norm and
# the first moments are held at that scale
NORM_RTOL, MU_REL = 1e-4, 1e-5
B, S = 4, 16


def _named(tree, cfg) -> dict:
    model = params_from_jax(jax.tree.map(np.asarray, tree), cfg, device="cpu",
                            dtype=torch.float32)
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_at_default_eps(arch):
    check_step(arch)


def check_step(arch: str) -> None:
    """One step of ``arch``'s SMOKE config in both packages, held as the
    module docstring says."""
    cfg = configs.get_config(arch, smoke=True)
    tcfg = optim.TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=4)
    assert tcfg.eps == 1e-8
    ref_cfg = ref_optim.TrainConfig(**tcfg.__dict__)
    tree = draw_constants(ref_tree(tf.init_params(cfg, torch.Generator().manual_seed(31),
                                                  device="cpu", dtype=torch.float32), cfg),
                          seed=32)
    rng = np.random.default_rng(33)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:]}

    p_ref = jax.tree.map(jnp.asarray, tree)
    p_ref, s_ref, m_ref = jax.jit(ref_step.make_train_step(cfg, ref_cfg))(
        p_ref, ref_step.init_opt_state(cfg, ref_cfg, p_ref), jax.tree.map(jnp.asarray, batch))
    model = params_from_jax(tree, cfg, device="cpu", dtype=torch.float32)
    model, opt, m = make_train_step(cfg, tcfg)(model, init_opt_state(cfg, tcfg, model),
                                                {k: torch.from_numpy(v) for k, v in batch.items()})

    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(float(m["grad_norm"]), float(m_ref["grad_norm"]),
                               rtol=NORM_RTOL)
    mu_ref, nu_ref = _named(s_ref["mu"], cfg), _named(s_ref["nu"], cfg)
    params_ref = _named(p_ref, cfg)
    dg = 0.0
    for n, p in model.named_parameters():
        mu, nu = opt["mu"][n].numpy(), opt["nu"][n].numpy()
        mu_tol = MU_REL * max(float(np.abs(mu_ref[n]).max()), 1.0)
        np.testing.assert_allclose(mu, mu_ref[n], atol=mu_tol, rtol=0, err_msg=f"mu {n}")
        dg = max(dg, float(np.abs(mu - mu_ref[n]).max()) / (1 - tcfg.beta1))
    g_ref = {n: mu_ref[n] / (1 - tcfg.beta1) for n in mu_ref}
    g_max = max(float(np.abs(g).max()) for g in g_ref.values())
    # plus 1% for the f32 rounding of the moments that dg is read from
    nu_tol = 1.01 * (1 - tcfg.beta2) * (2 * g_max * dg + dg ** 2) + 1e-12
    apart = 0
    for n, p in model.named_parameters():
        np.testing.assert_allclose(opt["nu"][n].numpy(), nu_ref[n], atol=nu_tol, rtol=0,
                                   err_msg=f"nu {n}")
        diff = np.abs(p.detach().numpy() - params_ref[n])
        hazard = np.abs(g_ref[n]) <= HAZARD_GRAD
        assert np.all(diff[~hazard] <= PARAM_ATOL), (n, float(diff[~hazard].max()))
        assert np.all(diff[hazard] <= 2 * LR + PARAM_ATOL), n
        apart += int((diff > PARAM_ATOL).sum())
    assert int(opt["step"]) == int(s_ref["step"]) == 1
    # the hazard is rare: a few entries of the whole model at most
    assert apart <= 1e-3 * sum(p.numel() for p in model.parameters()), apart
