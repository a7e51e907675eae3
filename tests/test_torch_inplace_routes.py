"""The in-place route's refusals, its triangle count, its byte models and
the host side of its launches, on the CPU.

``chunked_spgemm(..., slow_reads="in_place")`` and ``count_triangles(...,
slow_reads="in_place")`` launch the streaming kernel once a call on slow
operands in pinned host memory. Here ``torch.Tensor.is_pinned`` is patched
to True where a test needs operands that look slow (as in
``tests/test_torch_placement*.py``), the executors stage as for the card
where a test says so (``card_staging``), and the kernels' plain versions
run.
"""

import functools

import pytest
import torch

from repro.core import triangle as ref_tri
from repro_torch.core import backend_registry, chunk_stream, copy_ring, planner, triangle
from repro_torch.core.chunking import chunked_spgemm
from repro_torch.core.placement import ALL_FAST, TABLE3, card_bytes
from repro_torch.core.planner import ChunkPlan
from repro_torch.kernels import _build, bsr_spgemm, link_reads
from repro_torch.kernels import hash_accum_spgemm as hmod
from repro_torch.kernels import ranged_spgemm as rmod
from repro_torch.kernels import sparse_accum_spgemm as esc
from repro_torch.sparse.csr import CSR, csr_on_one_device, kernel_device
from test_torch_inplace_parity import card_staging  # noqa: F401  (a fixture)
from test_torch_triangle import _lower

GRAPH = "g500_s7"


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a, **k: True)


def _thirds(n):
    return (0, n // 3, 2 * n // 3, n)


@functools.lru_cache(maxsize=None)
def _graph():
    ref_L, L = _lower(GRAPH)
    return L, float(ref_tri.count_triangles_dense(ref_L))


@pytest.mark.parametrize("algorithm", ("knl", "chunk2"))
@pytest.mark.parametrize("name", ("HostPin", "DP", "B_Pin"))
def test_count_triangles_in_place_equals_reference(name, algorithm, card_staging):
    """The fused count with L's slow roles read in place equals the
    reference's, on the run device, with no ring op; staged as for the
    card, each slow role's stacks are pinned (C's: the mask, C_prev and
    the masked C)."""
    L, want = _graph()
    n = L.n_rows
    plan = (None if algorithm == "knl"
            else ChunkPlan("chunk2", _thirds(n), _thirds(n), 0.0, 0.0))
    with copy_ring.RingLog() as log:
        got = triangle.count_triangles(L, plan=plan, placement=TABLE3[name], device="cpu",
                                       slow_reads="in_place")
    slow = [getattr(TABLE3[name], k) == "slow" for k in "ABC"]
    assert card_staging == ["csr"] * (slow[0] + slow[1] + 3 * slow[2])
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert float(got) == want
    assert log.rings == [] and log.transfers == []


@pytest.mark.parametrize("backend", ("scan", "loop", "bsr"))
def test_backends_without_a_streaming_kernel_refuse_in_place(backend):
    L, _ = _graph()
    n = L.n_rows
    plan = ChunkPlan("chunk2", _thirds(n), _thirds(n), 0.0, 0.0)
    with pytest.raises(ValueError, match="pallas, sparse, hash, and auto"):
        chunked_spgemm(L, L, plan, backend=backend, device="cpu", slow_reads="in_place")


def test_whole_fast_and_unknown_modes_refuse_in_place():
    L, _ = _graph()
    plan = ChunkPlan("whole_fast", (0, L.n_rows), (0, L.n_rows), 0.0, 0.0)
    with pytest.raises(ValueError, match="whole_fast"):
        chunked_spgemm(L, L, plan, backend="hash", device="cpu", slow_reads="in_place")
    with pytest.raises(ValueError, match="slow_reads must be one of"):
        chunked_spgemm(L, L, plan, backend="hash", device="cpu", slow_reads="mapped")
    with pytest.raises(ValueError, match="slow_reads must be one of"):
        triangle.count_triangles(L, device="cpu", slow_reads="mapped")


def test_auto_resolving_to_a_backend_without_a_streaming_kernel_refuses(monkeypatch):
    L, _ = _graph()
    n = L.n_rows
    plan = ChunkPlan("chunk2", _thirds(n), _thirds(n), 0.0, 0.0)
    monkeypatch.setattr(planner, "select_accumulator_backend", lambda plan, env: "bsr")
    with pytest.raises(ValueError, match="auto' resolves to 'bsr'"):
        chunked_spgemm(L, L, plan, backend="auto", device="cpu", slow_reads="in_place")
    assert backend_registry.in_place_backends() == ("pallas", "sparse", "hash")


def _tiny_stacks():
    """A one-strip A of 2 rows (columns {0, 2} and {1}, 4 slots), B in two
    chunks of 2 rows (rows of 3, 1, 2 and 0 entries, 4 slots each), an
    empty C_prev of 8 slots and a mask of 2 rows (2 and 1 entries)."""
    f32, i32 = torch.float32, torch.int32
    A = CSR(torch.tensor([[[0, 2, 3]]], dtype=i32), torch.tensor([[[0, 2, 1, 0]]], dtype=i32),
            torch.ones(1, 1, 4, dtype=f32), (2, 4), 2)
    B = CSR(torch.tensor([[[0, 3, 4], [0, 2, 2]]], dtype=i32),
            torch.tensor([[[0, 1, 2, 0], [1, 2, 0, 0]]], dtype=i32),
            torch.ones(1, 2, 4, dtype=f32), (2, 3), 3)
    C0 = CSR(torch.zeros(1, 1, 3, dtype=i32), torch.zeros(1, 1, 8, dtype=i32),
             torch.zeros(1, 1, 8, dtype=f32), (2, 3), 8)
    M = CSR(torch.tensor([[[0, 2, 3]]], dtype=i32), torch.tensor([[[0, 2, 1, 0]]], dtype=i32),
            torch.ones(1, 1, 4, dtype=f32), (2, 3), 2)
    return A, B, C0, M, [0, 2], [2, 4]


def test_csr_read_model_on_a_hand_counted_case():
    """Every A entry is in range of one chunk: 3 entries, whose B rows hold
    3, 1 and 2 entries (6 products). chunk1: A = 8 x 2 rows + 4 x 3
    columns x 2 chunks + 4 x 3 values = 52; B = 8 x 3 indptr pairs + 8 x
    6 entries = 72; C = 8 x 2 (C_prev's pairs) + 4 x 3 (indptr) + 4 x 2
    (read back) + 8 x 8 slots = 100. chunk2 reads A's pairs once a chunk
    (68). The mask: 8 x 2 + 4 x 3 = 28 a step; the masked C 8 x 2 + 8 x 3
    entries written (chunk2: twice, and read back once)."""
    A, B, C0, M, r0s, r1s = _tiny_stacks()
    assert link_reads.csr_reads(A, B, C0, r0s, r1s, order="chunk1") == {
        "A": 52, "B": 72, "C": 100}
    assert link_reads.csr_reads(A, B, C0, r0s, r1s, order="chunk2")["A"] == 68
    assert link_reads.csr_reads(A, B, C0, r0s, r1s, order="chunk1", Mst=M) == {
        "A": 52, "B": 72, "M": 28, "C": 40}
    assert link_reads.csr_reads(A, B, C0, r0s, r1s, order="chunk2", Mst=M) == {
        "A": 68, "B": 72, "M": 56, "C": 88}
    reads = {"A": 52, "B": 72, "C": 100, "M": 28}
    assert link_reads.slow_total(reads, TABLE3["HostPin"]) == 252
    assert link_reads.slow_total(reads, TABLE3["B_Pin"]) == 72
    assert link_reads.slow_total(reads, TABLE3["C_Pin"]) == 128   # C and the mask
    assert link_reads.slow_total(reads, ALL_FAST) == 0


def test_dense_read_model_on_a_hand_counted_case():
    """Two strips of 130 rows (2 row tiles) by 200 columns (2 column
    tiles), three chunks of 100 rows: A's 3 x 100 chunk columns of every
    row once a column tile, every slab once a row tile, C read and written
    once a chunk."""
    assert link_reads.dense_reads((1, 2, 130, 400), (1, 3, 100, 200)) == {
        "A": 4 * 2 * 130 * 300 * 2, "B": 4 * 2 * 2 * 300 * 200, "C": 8 * 2 * 130 * 200 * 3}


def test_card_model_holds_no_byte_of_a_slow_operand():
    plan = ChunkPlan("chunk2", (0, 5, 10), (0, 4, 8, 12), 0.0, 0.0)
    sizes = dict(a_stage=100, slab=10, c_stage=7, workspace=3, c_bytes=50)
    host_pin = card_bytes(plan, TABLE3["HostPin"], slow_reads="in_place", **sizes)
    assert host_pin == {"A": 0, "B": 0, "C": 0, "workspace": 3, "total": 3}
    hbm = card_bytes(plan, ALL_FAST, slow_reads="in_place", **sizes)
    assert hbm == {"A": 400, "B": 60, "C": 78, "workspace": 3, "total": 541}
    # the ring's model: two slots a slow operand, Chunk2's block of C twice
    ring = card_bytes(plan, TABLE3["HostPin"], **sizes)
    assert ring == {"A": 200, "B": 20, "C": 28, "workspace": 3, "total": 251}


def _csr_calls(A, B, C0, M, r0s, r1s, a_dense=None):
    a_dense = torch.ones(1, 1, 2, 8) if a_dense is None else a_dense
    return {
        "sparse_accum_spgemm_stream": lambda **kw: esc.sparse_accum_spgemm_stream(
            A, B, C0, r0s, r1s, order="chunk1", row_cap=8, **kw),
        "hash_accum_spgemm_stream": lambda **kw: hmod.hash_accum_spgemm_stream(
            A, B, C0, r0s, r1s, order="chunk1", table_size=8, **kw),
        "hash_masked_accum_spgemm_stream": lambda **kw: hmod.hash_masked_accum_spgemm_stream(
            A, B, C0, M, r0s, r1s, order="chunk1", table_size=8, **kw),
        "ranged_spgemm_stream": lambda **kw: rmod.ranged_spgemm_stream(
            a_dense, torch.ones(1, 2, 2, 3), torch.zeros(1, 1, 2, 3),
            [0, 2], order="chunk1", **kw),
    }


def _on_meta(x):
    """``x`` on the meta device, which stands in for the card here."""
    if isinstance(x, CSR):
        return CSR(*(t.to("meta") for t in (x.indptr, x.indices, x.data)), x.shape,
                   x.max_row_nnz)
    return x.to("meta")


def test_wrappers_refuse_a_pinned_operand_without_a_run_device(monkeypatch):
    """Without ``device=`` a wrapper reads only the card, so a pinned host
    operand raises, whether the first operand lies on the host or on the
    card (here the meta device stands in for it); ``device="cpu"`` runs the
    plain version on it, equal to the plain version on pageable
    operands."""
    A, B, C0, M, r0s, r1s = _tiny_stacks()
    calls = _csr_calls(A, B, C0, M, r0s, r1s)
    plain = {name: call() for name, call in calls.items()}
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a, **k: True)
    for name, call in calls.items():
        with pytest.raises(ValueError, match=f"{name}: an operand is in pinned host memory"):
            call()
        got = call(device="cpu")
        want = plain[name]
        for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
            assert torch.equal(g, w), name
    # the first operand on the card, the others pinned on the host
    monkeypatch.setattr(torch.Tensor, "is_pinned",
                        lambda self, *a, **k: self.device.type == "cpu")
    mixed = _csr_calls(_on_meta(A), B, C0, M, r0s, r1s, a_dense=_on_meta(torch.ones(1, 1, 2, 8)))
    for name, call in mixed.items():
        with pytest.raises(ValueError, match=f"{name}: an operand is in pinned host memory"):
            call()


def test_kernel_device_and_the_in_place_operand_checks(monkeypatch):
    """``kernel_device``: a card operand alone runs where it lies, a card
    ``device`` launches there (pinned host operands read in place), "cpu"
    refuses a card operand. ``require(..., in_place=True)`` takes pinned
    host memory and refuses pageable memory; without ``in_place`` a host
    operand of a card launch raises. ``pointer`` marks a host operand as
    read in place and passes a card one as it is."""
    card = torch.zeros(4, device="meta")
    host = torch.zeros(4)
    assert kernel_device("k", None, card) == torch.device("meta")
    assert kernel_device("k", None, host) is None
    assert kernel_device("k", "cuda:0", card, host) == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="k: an operand is on the card in a CPU run"):
        kernel_device("k", "cpu", host, card)
    dev = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="a_dense is in pageable host memory"):
        _build.require(host, "a_dense", torch.float32, dev, in_place=True)
    with pytest.raises(ValueError, match="a_dense is on cpu, expected cuda:0"):
        _build.require(host, "a_dense", torch.float32, dev)
    assert isinstance(_build.pointer(host), _build.InPlace)
    assert _build.pointer(card) is card
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a, **k: True)
    _build.require(host, "a_dense", torch.float32, dev, in_place=True)
    with pytest.raises(ValueError, match="dtype torch.float32, expected torch.int32"):
        _build.require(host, "a_dense", torch.int32, dev, in_place=True)
    with pytest.raises(ValueError, match="must be contiguous"):
        _build.require(torch.zeros(4, 2).t(), "a_dense", torch.float32, dev, in_place=True)


def test_bsr_wrapper_refuses_a_pinned_operand(pinned):
    with pytest.raises(ValueError, match="bsr_spgemm_blocks: an operand is in pinned"):
        bsr_spgemm.bsr_spgemm_blocks(torch.zeros(2, 4, 4), torch.zeros(2, 4, 4),
                                     torch.zeros((1, 1), dtype=torch.int32),
                                     torch.zeros((1, 1), dtype=torch.int32), nc_pad=1,
                                     u_max=1, bs=4)


def _graph_stacks(pin=(False, False, False)):
    """L's strips and chunks (thirds) as the masked and ESC wrappers take
    them, with an empty C_prev at the masked capacity; ``pin`` builds A's,
    B's and C's stacks as an in-place call builds its slow ones."""
    from repro_torch.core.symbolic import masked_output_caps

    L, _ = _graph()
    n = L.n_rows
    plan = ChunkPlan("chunk2", _thirds(n), _thirds(n), 0.0, 0.0)
    caps = masked_output_caps(L, plan.p_ac)
    (Ast, Bst, C0, Mst, r0s, r1s), _, _ = chunk_stream.stage_hash_masked(
        L, L, L, plan, caps.c_pad, caps, pin=pin)
    return Ast, Bst, C0, Mst, r0s, r1s


def test_host_side_plans_on_pinned_operands_equal_the_unpinned_plans(card_staging):
    """The ESC launch plan (a counted call: rows past a block's shared
    memory) and the masked work list and launches come out the same from
    the stacks an in-place call stages in pinned memory (every role slow)
    as from the all-fast call's: on the card the wrapper cuts them on the
    host from the former, on the card from the latter."""
    row_cap = 1 << 14    # a launch-wide bound past shared memory: the steps are counted

    def plans(stacks):
        Ast, Bst, C0, Mst, r0s, r1s = stacks
        launch = esc.esc_launch_plan(Ast, Bst, C0, r0s, r1s, row_cap=row_cap)
        work = hmod.masked_work(Ast, Bst, Mst, r0s, r1s, n_sm=132)
        return launch, work, hmod.masked_launches(work, Mst)

    want = plans(_graph_stacks())
    assert card_staging == []
    got = plans(_graph_stacks(pin=(True, True, True)))
    assert card_staging == ["csr"] * 4   # A, B, the mask and C_prev
    assert want[0].split and got[0].split
    assert torch.equal(got[0].items, want[0].items) and got[0].starts == want[0].starts
    assert torch.equal(got[0].offsets, want[0].offsets) and got[0].routes == want[0].routes
    for g, w in zip(got[1][:-1], want[1][:-1]):
        assert torch.equal(g, w)
    assert got[1].part_size == want[1].part_size
    for g, w in zip(got[2][:-1], want[2][:-1]):
        assert torch.equal(g, w)
    assert got[2].groups == want[2].groups


@pytest.mark.parametrize("slow_reads", ("ring", "in_place"))
def test_hoisted_symbolic_phase_gives_the_same_call(slow_reads, monkeypatch):
    """``caps=`` (the symbolic phase, hoisted out of a timed call) gives the
    call it would have computed; caps of another plan's strips raise."""
    from repro_torch.core.symbolic import strip_output_caps
    from repro_torch.sparse.multigrid import problem

    A, _, P = problem("brick3d", 4, device="cpu")
    plan = ChunkPlan("chunk2", _thirds(A.n_rows), _thirds(P.n_rows), 0.0, 0.0)
    caps = strip_output_caps(A, P, plan.p_ac)
    want = chunked_spgemm(A, P, plan, backend="hash", device="cpu")
    if slow_reads == "in_place":   # the operands look slow to the wrappers
        monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a, **k: True)
    got = chunked_spgemm(A, P, plan, backend="hash", device="cpu", placement=TABLE3["HostPin"],
                         slow_reads=slow_reads, caps=caps)
    assert got[1] == want[1]
    for f in ("indptr", "indices", "data"):
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    knl = ChunkPlan("knl", (0, A.n_rows), _thirds(P.n_rows), 0.0, 0.0)
    with pytest.raises(ValueError, match="caps hold 3 strips, the plan 1"):
        chunked_spgemm(A, P, knl, backend="hash", device="cpu", slow_reads=slow_reads,
                       caps=caps)


def test_pinned_for_and_one_device_stacks():
    """An in-place call pins the slow operands of a card launch and nothing
    of a CPU run (both spaces are host memory there); stacks that share a
    device are planned where they lie, untouched."""
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    want = {"HBM": (False, False, False), "A_Pin": (True, False, False),
            "B_Pin": (False, True, False), "C_Pin": (False, False, True),
            "HostPin": (True, True, True)}
    for name, pins in want.items():
        assert chunk_stream._pinned_for(TABLE3[name], card) == pins, name
        assert chunk_stream._pinned_for(TABLE3[name], cpu) == (False,) * 3, name
    dp = TABLE3["DP"]
    assert chunk_stream._pinned_for(dp, card) == tuple(getattr(dp, k) == "slow" for k in "ABC")
    A, B, C0, *_ = _tiny_stacks()
    got = csr_on_one_device(A, B, C0)
    assert all(g is w for g, w in zip(got, (A, B, C0)))
