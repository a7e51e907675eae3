"""The levers on the whole bf16 llama SMOKE variant (dense) against the JAX
package: ``precast_params`` and ``cast_free_attention`` alone and together
in the forward, the loss and every gradient, prefill and a decode step, at
the bf16 tolerances of ``test_torch_levers.check_lever``, and each lever's
effect on the logits against the reference's."""

import pytest

from test_torch_levers import check_lever
from test_torch_train_forward import one_torch_thread  # noqa: F401 (a fixture)


@pytest.mark.parametrize("setting,full", [("off", False), ("precast", True),
                                          ("cast_free", True), ("both", True)])
def test_levers_on_the_dense_model(setting, full):
    check_lever("llama", setting, full)
