"""One ``make_train_step`` step against the JAX package's at AdamW's
default eps (1e-8) on the zamba2 SMOKE config (f32), held as
``test_torch_train_default_eps.py`` holds llama and rwkv6: the shared
block's gradient sums over its sites."""

from test_torch_train_default_eps import check_step
from test_torch_train_forward import one_torch_thread  # noqa: F401 (a fixture)


def test_hybrid_train_step_matches_reference_at_default_eps():
    check_step("zamba2_1p2b")
