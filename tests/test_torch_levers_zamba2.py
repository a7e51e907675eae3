"""The levers on the whole bf16 zamba2 SMOKE variant (hybrid) against the JAX
package, at the bf16 tolerances of ``test_torch_levers.check_lever``:
``precast_params`` (which rounds ``A_log``, ``dt_bias``, ``D``,
``norm_scale`` and the norm scales) in the forward, the loss and every
gradient, prefill and a decode step, and its effect on the logits against
the reference's;
``cast_free_attention`` alone and with ``precast_params`` in the forward.
Zamba2's shared attention runs in f32 (its stream is f32 after the first
Mamba-2 block: P rounded to V's f32 is P), so ``cast_free_attention``
changes nothing in either package: the logits with it equal those without
it, bit for bit."""

import numpy as np
import pytest

from test_torch_levers import check_lever, port_run, reference_run
from test_torch_train_forward import one_torch_thread  # noqa: F401 (a fixture)

FAMILY = "zamba2"


@pytest.mark.parametrize("setting,full", [("off", False), ("precast", True),
                                          ("cast_free", False), ("both", False)])
def test_levers_on_the_hybrid_model(setting, full):
    check_lever(FAMILY, setting, full)
    if setting in ("cast_free", "both"):
        base = "off" if setting == "cast_free" else "precast"
        for run in (port_run, reference_run):
            np.testing.assert_array_equal(run(FAMILY, setting, False)["logits"],
                                          run(FAMILY, base, setting == "both")["logits"])
