"""``cast_free_attention`` alone and with ``precast_params`` on the whole
bf16 OLMoE SMOKE variant (MoE) against the JAX package: the forward, the
loss and every gradient, prefill and a decode step, at the bf16 tolerances
of ``test_torch_levers.check_lever``, and the levers' effect on the logits
against the reference's."""

import pytest

from test_torch_levers import check_lever
from test_torch_train_forward import one_torch_thread  # noqa: F401 (a fixture)


@pytest.mark.parametrize("setting", ["cast_free", "both"])
def test_cast_free_on_the_moe_model(setting):
    check_lever("olmoe", setting)
