"""Parity of the port's CSR layer and generators with the JAX package.

The same seeded inputs go through ``repro.sparse`` and ``repro_torch.sparse``
(on the CPU); arrays must be bitwise equal and metadata identical.
"""

import numpy as np
import pytest
import torch

from repro.sparse import csr as ref_csr
from repro.sparse import generators as ref_gen
from repro.sparse import multigrid as ref_mg
from repro_torch.kernels.convert import csr_fields, csr_from_fields
from repro_torch.sparse import csr as port_csr
from repro_torch.sparse import generators as port_gen
from repro_torch.sparse import multigrid as port_mg

CPU = "cpu"


def _same(ref, port):
    """Bitwise equality of a reference CSR and a port CSR."""
    got = csr_fields(port)
    assert got["shape"] == tuple(ref.shape)
    assert got["max_row_nnz"] == ref.max_row_nnz
    for f in ("indptr", "indices", "data"):
        want = np.asarray(getattr(ref, f))
        assert got[f].dtype == want.dtype, f
        np.testing.assert_array_equal(got[f], want, err_msg=f)


def _port(ref):
    return csr_from_fields(np.asarray(ref.indptr), np.asarray(ref.indices),
                           np.asarray(ref.data), ref.shape, ref.max_row_nnz,
                           device=CPU)


def _dense(rng, m, n, density):
    return ((rng.random((m, n)) < density)
            * rng.standard_normal((m, n))).astype(np.float32)


@pytest.mark.parametrize("name", ref_mg.PROBLEMS)
@pytest.mark.parametrize("n", [3, 6])
def test_multigrid_problems_bitwise(name, n):
    for ref, port in zip(ref_mg.problem(name, n), port_mg.problem(name, n, device=CPU)):
        _same(ref, port)


def test_multigrid_pad_to_forwarded():
    refs = ref_mg.problem("brick3d", 3, pad_to=2048)
    ports = port_mg.problem("brick3d", 3, pad_to=2048, device=CPU)
    for ref, port in zip(refs, ports):
        _same(ref, port)
    assert ports[0].nnz_pad == ports[1].nnz_pad == 2048   # A and R; P = R^T


@pytest.mark.parametrize("seed", [0, 1])
def test_generators_bitwise(seed):
    _same(ref_gen.random_uniform_degree(20, 30, 4, seed=seed),
          port_gen.random_uniform_degree(20, 30, 4, seed=seed, device=CPU))
    _same(ref_gen.random_uniform_degree(12, 500, 3, seed=seed),
          port_gen.random_uniform_degree(12, 500, 3, seed=seed, device=CPU))
    _same(ref_gen.random_uniform_degree(12, 40, 5, seed=seed, exact=False),
          port_gen.random_uniform_degree(12, 40, 5, seed=seed, exact=False,
                                         device=CPU))
    _same(ref_gen.random_banded(25, 3, 0.5, seed=seed),
          port_gen.random_banded(25, 3, 0.5, seed=seed, device=CPU))


@pytest.mark.parametrize("pad_extra", [0, 7])
def test_csr_constructors_bitwise(pad_extra):
    rng = np.random.default_rng(11)
    d = _dense(rng, 9, 13, 0.3)
    d[4] = 0.0
    nnz = int((d != 0).sum())
    _same(ref_csr.csr_from_dense(d, pad_to=nnz + pad_extra),
          port_csr.csr_from_dense(d, pad_to=nnz + pad_extra, device=CPU))
    # the tensor path converts on the device and gives the same entries
    _same(ref_csr.csr_from_dense(d, pad_to=nnz + pad_extra),
          port_csr.csr_from_dense(torch.from_numpy(d), pad_to=nnz + pad_extra,
                                  device=CPU))
    rows = rng.integers(0, 9, 40)
    cols = rng.integers(0, 13, 40)
    vals = rng.standard_normal(40)
    _same(ref_csr.csr_from_coo(rows, cols, vals, (9, 13), pad_to=64),
          port_csr.csr_from_coo(rows, cols, vals, (9, 13), pad_to=64, device=CPU))
    ref = ref_csr.csr_from_dense(d)
    np.testing.assert_array_equal(
        port_csr.csr_to_dense(_port(ref)).numpy(),
        np.asarray(ref_csr.csr_to_dense(ref)))
    np.testing.assert_array_equal(
        port_csr.csr_row_of_entry(_port(ref)).numpy(),
        np.asarray(ref_csr.csr_row_of_entry(ref)))


def test_csr_row_ops_bitwise():
    rng = np.random.default_rng(5)
    ref = ref_csr.csr_from_dense(_dense(rng, 15, 11, 0.35))
    port = _port(ref)
    for r0, r1, pad in [(0, 15, None), (3, 9, None), (4, 4, None), (2, 12, 80)]:
        _same(ref_csr.csr_select_rows_host(ref, r0, r1, pad_to=pad),
              port_csr.csr_select_rows_host(port, r0, r1, pad_to=pad))
    _same(ref_csr.csr_pad_to(ref, nnz_cap=ref.nnz_pad + 9, rows=20, max_row_nnz=30),
          port_csr.csr_pad_to(port, nnz_cap=port.nnz_pad + 9, rows=20, max_row_nnz=30))
    with pytest.raises(ValueError, match="only grows"):
        port_csr.csr_pad_to(port, rows=3)
    _same(ref_csr.csr_transpose_host(ref), port_csr.csr_transpose_host(port))
    _same(ref_csr.csr_transpose_host(ref, pad_to=200),
          port_csr.csr_transpose_host(port, pad_to=200))


def test_csr_stack_unstack_bitwise():
    rng = np.random.default_rng(8)
    refs = [ref_csr.csr_pad_to(ref_csr.csr_from_dense(_dense(rng, 6, 7, 0.4)),
                               nnz_cap=42, max_row_nnz=7) for _ in range(3)]
    ports = [_port(r) for r in refs]
    ref_st, port_st = ref_csr.csr_stack(refs), port_csr.csr_stack(ports)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(port_st, f).numpy(),
                                      np.asarray(getattr(ref_st, f)))
    assert port_st.shape == ref_st.shape and port_st.max_row_nnz == ref_st.max_row_nnz
    for r, p in zip(ref_csr.csr_unstack(ref_st), port_csr.csr_unstack(port_st)):
        _same(r, p)
    bad = ports[:2] + [port_csr.csr_pad_to(ports[2], nnz_cap=50)]
    with pytest.raises(ValueError, match="uniform"):
        port_csr.csr_stack(bad)


def _env_pair(**kw):
    fields = dict(a_shape=(10, 8), b_shape=(8, 6), a_nnz_cap=40,
                  a_max_row_nnz=5, b_max_row_nnz=3, chunk_rows=4,
                  chunk_nnz_cap=12, strip_rows=5, strip_nnz_cap=20, c_pad=33,
                  dtype="float32", c_nnz_cap=64, c_max_row_nnz=6)
    fields.update(kw)
    return (ref_csr.GeometryEnvelope(**fields),
            port_csr.GeometryEnvelope(**fields))


def test_geometry_envelope_algebra_equal():
    r1, p1 = _env_pair()
    r2, p2 = _env_pair(a_nnz_cap=70, c_pad=12, c_max_row_nnz=0, strip_rows=9,
                       b_max_row_nnz=5)
    assert dataclass_tuple(p1.union(p2)) == dataclass_tuple(r1.union(r2))
    assert p1.union(p2).dominates(p1) == r1.union(r2).dominates(r1)
    assert p1.dominates(p2) == r1.dominates(r2)
    for q in (8, 32):
        assert dataclass_tuple(p2.quantized(q)) == dataclass_tuple(r2.quantized(q))
    assert p1.staged_nbytes() == r1.staged_nbytes()
    assert p2.staged_nbytes() == r2.staged_nbytes()
    r3, p3 = _env_pair(bsr_caps=(8, 16, 16, 24, 4))
    r4, p4 = _env_pair(bsr_caps=(8, 8, 32, 16, 8))
    assert dataclass_tuple(p3.union(p4)) == dataclass_tuple(r3.union(r4))
    with pytest.raises(ValueError, match="block-capped"):
        p1.union(p3)
    _, p5 = _env_pair(a_shape=(11, 8))
    with pytest.raises(ValueError, match="incompatible"):
        p1.union(p5)


def dataclass_tuple(env):
    return tuple(getattr(env, f) for f in env.__dataclass_fields__)
