"""``precast_params`` on the whole bf16 OLMoE SMOKE variant (MoE) against
the JAX package (it also rounds the router, read in f32 with the lever
off): the forward, the loss and every gradient, prefill and a decode step,
at the bf16 tolerances of ``test_torch_levers.check_lever``, and its effect
on the logits against the reference's. ``cast_free_attention`` alone and
with it: ``test_torch_levers_olmoe_cast_free.py``."""

import pytest

from test_torch_levers import check_lever
from test_torch_train_forward import one_torch_thread  # noqa: F401 (a fixture)


@pytest.mark.parametrize("setting,full", [("off", False), ("precast", True)])
def test_precast_on_the_moe_model(setting, full):
    check_lever("olmoe", setting, full)
