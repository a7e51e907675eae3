"""The port's examples (``examples/torch_*.py``) beside the reference's, on
the CPU at the reference example tests' sizes: each prints the reference's
lines, equal line for line once the timings ("in N ms") are taken out, and
``locality.miss_table`` equals the reference's on the conformance
geometries.

The triangle example's timing lines are the one deliberate difference: the
port's time includes the work its device ran (a sync on the card), and the
numbers differ from run to run in both packages."""

import contextlib
import io
import re
import sys

import numpy as np
import pytest

from repro.core.locality import miss_table as ref_miss_table
from repro_torch.core.locality import miss_table
from test_backend_conformance import CASES
from test_torch_sparse_accum import _port

TIMING = re.compile(r" in \d+ ms")


def output(fn) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return [TIMING.sub(" in <ms>", line) for line in buf.getvalue().splitlines()]


def test_quickstart_prints_the_reference_lines():
    from examples import quickstart, torch_quickstart

    want = output(quickstart.main)
    got = output(lambda: torch_quickstart.main(device="cpu"))
    assert got == want
    assert "chunked == unchunked == oracle; actual staged bytes" in got[4]


def test_triangle_count_prints_the_reference_lines(monkeypatch):
    from examples import torch_triangle_count, triangle_count

    monkeypatch.setattr(sys, "argv", ["triangle_count.py", "--scale", "7"])
    want = output(triangle_count.main)
    got = output(lambda: torch_triangle_count.main(["--scale", "7", "--device", "cpu"]))
    assert got == want
    assert any("agrees: True" in line for line in got)
    assert "[tc] dense oracle agrees: True" in got


def test_multigrid_spgemm_prints_the_reference_lines():
    """Every backend and ``auto`` on laplace3d n=5, and the two-hop
    pipeline through the ESC and hash kernels' plain versions."""
    from examples import multigrid_spgemm, torch_multigrid_spgemm

    args = ["--problem", "laplace3d", "--size", "5", "--backends", "all"]
    assert torch_multigrid_spgemm.ALL_BACKENDS == multigrid_spgemm.ALL_BACKENDS
    want = output(lambda: multigrid_spgemm.main(args))
    got = output(lambda: torch_multigrid_spgemm.main(args + ["--device", "cpu"]))
    assert got == want
    for backend in torch_multigrid_spgemm.ALL_BACKENDS:
        assert any(f"/{backend:6s}:" in line for line in got), backend
    assert not any("correct=False" in line for line in got)


def test_multigrid_spgemm_rejects_an_unknown_backend():
    from examples import torch_multigrid_spgemm

    with pytest.raises(SystemExit):
        torch_multigrid_spgemm.main(["--problem", "laplace3d", "--size", "5",
                                     "--backends", "nope", "--device", "cpu"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_miss_table_equals_the_reference(case):
    build, seed = CASES[case]
    A, B = build(np.random.default_rng(seed))
    for caps in (None, {"L1": 64, "L2": 512, "L3": 1 << 14}):
        assert miss_table(_port(A), _port(B), caps) == ref_miss_table(A, B, caps)


@pytest.mark.parametrize("problem", ["laplace3d", "brick3d"])
def test_miss_table_equals_the_reference_on_multigrid(problem):
    """The multigrid driver's pairs, A x P and R x A, with warm reuse."""
    from repro.sparse import multigrid as ref_multigrid

    A, R, P = ref_multigrid.problem(problem, 5)
    for L, Rt in ((A, P), (R, A)):
        want = ref_miss_table(L, Rt)
        assert want["mean_reuse_rows"] < float("inf")
        assert miss_table(_port(L), _port(Rt)) == want
