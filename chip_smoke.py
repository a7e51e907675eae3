"""Drive the PyTorch port's chunked-SpGEMM main path on one H100 and check it.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the CUDA kernels of
``src/repro_torch/kernels/csrc`` (into ``build/repro_torch/``), holds each
kernel, in both streaming orders, against its plain PyTorch version at the
shapes the main path stages, at a four-chunk plan with a nonzero C_prev, and
on a small geometry whose dense output row fills its hash table, then runs
the main path — ``multigrid.problem`` on the card, the host
symbolic phase and planner, ``chunked_spgemm`` — on the paper's problems, and
checks every result against the port's plain ``spgemm`` on the card and
against ``scipy.sparse`` in float64. Then the second path: fused-mask
triangle counting on a graph500 scale-18 RMAT graph (``count_triangles``,
the masked hash kernel, one chunk and a chunk2 plan), the two-hop Galerkin
product ``R x (A x P)`` on brick3d n=48 (``pipeline_spgemm`` through the
hash and ESC kernels, intermediate resident and spilled), the ``bsr``
backend on brick3d n=48 and ``ops.bsr_spmm`` of brick3d n=48 by a
110,592 x 128 dense block, each held to scipy in float64, with the masked,
BSR x BSR and BSR x dense kernels first held to their plain versions.
Every line of output is one JSON object; the last one is
``{"ok": true, "device": ...}``. Any failed check raises, so the exit code
is not 0. Without a CUDA card, or without the package beside this file, it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Data-sheet peaks of the H100 SXM (NVIDIA H100 data sheet: HBM3 bandwidth,
# FP32 outside the tensor cores, at 700 W), the card nvidia-smi names
# "NVIDIA H100 80GB HBM3". Another card has no peaks here and stops the run.
PEAK = {"part": "H100 SXM", "smi_name": "H100 80GB HBM3",
        "bytes_per_s": 3.35e12, "f32_flops": 67e12}

# tolerances: float32 sums taken in another order (and, for the hash kernel,
# in atomic order) than the plain version's
KERNEL_ATOL, KERNEL_RTOL = 1e-4, 1e-5
SCIPY_RTOL = 1e-4

ORDERS = ("chunk1", "chunk2")
EDGE_SEED = 108

REPLACES = {
    "ranged_spgemm": "src/repro/kernels/ranged_spgemm.py:131",
    "sparse_accum_spgemm": "src/repro/kernels/sparse_accum_spgemm.py:173",
    "hash_accum_spgemm": "src/repro/kernels/hash_accum_spgemm.py:310",
    "hash_masked_accum_spgemm": "src/repro/kernels/hash_accum_spgemm.py:289",
    "bsr_spgemm": "src/repro/kernels/bsr_spgemm.py:174",
    "bsr_spmm": "src/repro/kernels/bsr_spmm.py:67",
}
RMAT_SCALE, RMAT_EDGE_FACTOR, RMAT_SEED = 18, 16, 7   # graph500-style, ISSUE size
BSR_BLOCK = 8
SPMM_COLS, SPMM_SEED = 128, 12
# pipeline fast limits, as fractions of size(A) + size(P) + size(R): at the
# whole size the intermediate stays resident between chunked hops; at half it
# spills (the planner's choice at every brick3d size tried)
PIPE_RESIDENT, PIPE_SPILL = 1.0, 0.5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(torch, fn, reps: int = 5, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` by CUDA events, after ``warmup`` calls:
    the whole call, host work between its launches included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled(torch, fn):
    """A torch.profiler trace of one call of ``fn``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def device_busy_ms(prof) -> float:
    """Summed durations of a trace's device activities (kernels, copies, fills)."""
    from torch.autograd import DeviceType

    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


def device_ms(torch, fn, reps: int = 5) -> tuple:
    """Median device milliseconds of one call of a PyTorch function, one
    profiler trace per call, after a warm-up call, and the number of traces
    that saw no device activity at all: the profiler loses some calls whose
    kernel runs for hundreds of milliseconds, and those are left out (None
    when all are)."""
    fn()
    torch.cuda.synchronize()
    times = [device_busy_ms(profiled(torch, fn)) for _ in range(reps)]
    seen = [t for t in times if t > 0]
    return (statistics.median(seen) if seen else None), reps - len(seen)


def launch_ms(torch, timer_cls, fn, reps: int = 5) -> float:
    """Median milliseconds of the kernels one wrapper call launches, from
    events recorded on the stream around each launch, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        with timer_cls() as timer:
            fn()
        times.append(timer.ms())
    check(min(times) > 0, "a timed call launched no kernel")
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def live_bytes(st) -> int:
    """Bytes of a stacked CSR that a kernel must read: every indptr, and the
    entries each element's indptr bounds (not the padded tails)."""
    nnz = int(st.indptr[..., -1].sum())
    return nbytes(st.indptr) + nnz * (st.indices.element_size() + st.data.element_size())


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        from repro_torch.core import chunking, kkmem, memory_model, planner, symbolic
        from repro_torch.core import chunk_stream, pipeline_spgemm, triangle
        from repro_torch.kernels import (
            _build, bsr_spgemm, bsr_spmm, hash_accum_spgemm, ops, ranged_spgemm,
            sparse_accum_spgemm,
        )
        from repro_torch.sparse import bsr, csr, graphs, multigrid

        self.m = dict(chunking=chunking, kkmem=kkmem, memory_model=memory_model,
                      planner=planner, symbolic=symbolic, chunk_stream=chunk_stream,
                      build=_build, csr=csr, multigrid=multigrid, graphs=graphs,
                      bsr=bsr, triangle=triangle, pipeline=pipeline_spgemm, ops=ops)
        self.kernels = {"ranged_spgemm": ranged_spgemm,
                        "sparse_accum_spgemm": sparse_accum_spgemm,
                        "hash_accum_spgemm": hash_accum_spgemm,
                        "hash_masked_accum_spgemm": hash_accum_spgemm,
                        "bsr_spgemm": bsr_spgemm, "bsr_spmm": bsr_spmm}
        # each kernel's launch counter (the masked kernel's wrapper lives in
        # the hash module)
        self.counters = {k: mod.LAUNCHES for k, mod in self.kernels.items()}
        self.counters["hash_masked_accum_spgemm"] = hash_accum_spgemm.MASKED_LAUNCHES
        self.backend_kernel = {"pallas": "ranged_spgemm",
                               "sparse": "sparse_accum_spgemm",
                               "hash": "hash_accum_spgemm",
                               "bsr": "bsr_spgemm"}
        self.problems = {}
        self.restrictions = {}
        self.phase = {}       # kernel -> numbers of its recorded kernel phase
        self.max_err = {}     # kernel -> largest error against its plain version
        self.launches = {}    # kernel -> launches in its main-path run

    # -- setup -------------------------------------------------------------

    def card(self) -> dict:
        torch = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        name = torch.cuda.get_device_name(0)
        check(PEAK["smi_name"] in smi,
              f"nvidia-smi names {smi!r}; the bounds need the peaks of that card, "
              f"and only the {PEAK['part']}'s ({PEAK['smi_name']}) are known here")
        info = {"nvidia_smi": smi, "device_name": name,
                "device_count": torch.cuda.device_count(),
                "torch": torch.__version__, "cuda": torch.version.cuda,
                "peaks": PEAK}
        emit({"card": info})
        return info

    def launch_ms(self, fn) -> float:
        return launch_ms(self.torch, self.m["build"].LaunchTimer, fn)

    def reset_counters(self) -> None:
        for counter in self.counters.values():
            counter.reset()

    def read_counters(self) -> dict:
        return {k: c.count for k, c in self.counters.items()}

    def build(self) -> None:
        t0 = time.perf_counter()
        log = self.m["build"].build()
        seconds = time.perf_counter() - t0
        resources = {name: entry["kernels"] for name, entry in log.items()}
        emit({"build": {"seconds": seconds,
                        "per_source_s": {k: v["seconds"] for k, v in log.items()},
                        "ptxas": resources}})

    def problem(self, name: str, n: int):
        key = (name, n)
        if key not in self.problems:
            t0 = time.perf_counter()
            A, R, P = self.m["multigrid"].problem(name, n, device="cuda")
            self.problems[key] = (A, P, time.perf_counter() - t0)
            self.restrictions[key] = R
        return self.problems[key][:2]

    def quickstart_inputs(self, A, P):
        """examples/quickstart.py's C row-byte estimate and budget."""
        planner = self.m["planner"]
        ws = self.m["kkmem"].spgemm_symbolic_host(A, P)
        crb = np.full(A.n_rows, max(ws.c_nnz / A.n_rows, 1) * 12.0)
        budget = (float(planner.row_bytes_csr(A).sum() + planner.row_bytes_csr(P).sum())
                  + float(crb.sum())) / 4
        return crb, budget

    # -- kernel phases -----------------------------------------------------

    def stage_csr(self, A, P, plan, c0_from=None):
        """The stacked operands ``_sparse_run`` hands the CSR kernels. C_prev
        is empty, as on the main path, unless ``c0_from`` gives a matrix whose
        strips (at the output capacity) become a nonzero C_prev."""
        ch, cs, csr = self.m["chunking"], self.m["chunk_stream"], self.m["csr"]
        strips = ch.a_strips(A, plan.p_ac)
        chunks = ch.b_chunks(P, plan.p_b)
        caps = self.m["symbolic"].strip_output_caps(A, P, plan.p_ac)
        Ast = csr.csr_stack([csr.csr_stack(strips)])
        Bst = csr.csr_stack([csr.csr_stack(chunks)])
        if c0_from is None:
            C0 = cs._sparse_c0_stack(1, plan.n_ac, strips[0].n_rows, P.n_cols,
                                     caps.c_pad, A.dtype, A.device)
        else:
            C0 = csr.csr_stack([csr.csr_stack(
                [csr.csr_pad_to(s, caps.c_pad) for s in ch.a_strips(c0_from, plan.p_ac)])])
        r0s, r1s = plan.b_ranges()
        return Ast, Bst, C0, r0s, r1s, caps

    def library_spgemm(self, A, P):
        """One torch.sparse CSR x CSR product on the card (a yardstick only):
        (wall ms, device ms, empty traces, error text if torch refuses)."""
        torch = self.torch

        def as_torch(m):
            nnz = m.nnz()
            return torch.sparse_csr_tensor(m.indptr, m.indices[:nnz], m.data[:nnz],
                                           size=m.shape, check_invariants=False)
        a, p = as_torch(A), as_torch(P)
        fn = lambda: torch.sparse.mm(a, p)  # noqa: E731
        try:
            return (cuda_ms(torch, fn), *device_ms(torch, fn), None)
        except RuntimeError as err:   # torch refuses: record why, time nothing
            return None, None, None, str(err).splitlines()[0]

    def csr_runners(self, kernel: str, Ast, Bst, C0, r0s, r1s, row_cap: int):
        """(kernel, plain version) of one CSR kernel as functions of the order."""
        mod = self.kernels[kernel]
        if kernel == "hash_accum_spgemm":
            table = self.m["planner"].hash_table_slots(row_cap)
            return (lambda order: mod.hash_accum_spgemm_stream(
                        Ast, Bst, C0, r0s, r1s, order=order, table_size=table),
                    lambda order: mod.hash_accum_plain(
                        Ast, Bst, C0, r0s, r1s, order=order, table_size=table))
        return (lambda order: mod.sparse_accum_spgemm_stream(
                    Ast, Bst, C0, r0s, r1s, order=order, row_cap=row_cap),
                lambda order: mod.sparse_accum_plain(
                    Ast, Bst, C0, r0s, r1s, order=order))

    def hold_csr(self, what: str, got, want) -> dict:
        """Structure exact, values to tolerance, of a stacked CSR triple."""
        self.torch.cuda.synchronize()
        structure = (self.torch.equal(got[0], want[0]) and self.torch.equal(got[1], want[1]))
        err = float((got[2] - want[2]).abs().max()) if got[2].numel() else 0.0
        check(structure, f"{what}: structure differs from the plain version")
        check(bool(self.torch.allclose(got[2], want[2], atol=KERNEL_ATOL, rtol=KERNEL_RTOL)),
              f"{what}: values differ from the plain version by {err}")
        return {"structure_equal": structure, "max_abs_err": err}

    def hold_dense(self, what: str, got, want) -> dict:
        err = float((got - want).abs().max())
        check(err <= KERNEL_ATOL + KERNEL_RTOL * float(want.abs().max()),
              f"{what}: values differ from the plain version by {err}")
        return {"structure_equal": True, "max_abs_err": err}

    def csr_kernel_phase(self, kernel: str, A, P, plan, main_order: str, *,
                         label: str, c0_from=None, record: bool = False) -> None:
        """One CSR kernel in both orders at the staged shapes of ``plan``,
        held against its plain version. ``record`` marks the phase whose
        numbers the kernels line reports; it also times the plain version
        and the library yardstick."""
        torch = self.torch
        Ast, Bst, C0, r0s, r1s, caps = self.stage_csr(A, P, plan, c0_from)
        run, plain = self.csr_runners(kernel, Ast, Bst, C0, r0s, r1s, caps.c_max_row_nnz)
        orders = {}
        for order in ORDERS:
            orders[order] = self.hold_csr(f"{kernel}/{label}/{order}", run(order), plain(order))
            orders[order]["ms"] = self.launch_ms(lambda: run(order))
            orders[order]["wrapper_ms"] = cuda_ms(torch, lambda: run(order))
            if record:
                orders[order]["plain_ms"] = cuda_ms(torch, lambda: plain(order), reps=3)
        out = run(main_order)
        moved = (live_bytes(Ast) + live_bytes(Bst) + live_bytes(C0) + nbytes(*out)
                 + 8 * len(r0s))
        flops = (self.m["symbolic"].spgemm_structure_host(A, P).flops
                 + int(C0.indptr[..., -1].sum()))
        library = self.library_spgemm(A, P) if record else (None,) * 4
        self.finish_phase(kernel, label, orders, main_order, moved, flops, library,
                          {"strips": plan.n_ac, "chunks": plan.n_b,
                           "strip_rows": Ast.n_rows, "a_cap": Ast.nnz_pad,
                           "chunk_cap": Bst.nnz_pad, "c_cap": C0.nnz_pad,
                           "nnz_c0": int(C0.indptr[..., -1].sum()),
                           "c_max_row_nnz": caps.c_max_row_nnz}, record)

    def dense_stage(self, A, P, plan):
        """The dense strips (``k + span`` columns) and slabs the ``pallas``
        executors stage, with a leading batch axis."""
        ch, cs, csr = self.m["chunking"], self.m["chunk_stream"], self.m["csr"]
        Bs = csr.csr_stack(ch.b_chunks(P, plan.p_b))
        a = cs._dense_stack(csr.csr_stack(ch.a_strips(A, plan.p_ac)), levels=1,
                            pad_cols=Bs.n_rows)[None]
        return a, cs._dense_stack(Bs, levels=1)[None]

    def dense_kernel_phase(self, A, P, plan, *, label: str, c0_seed: int | None = None,
                           record: bool = False) -> None:
        """The dense-slab kernel in both orders at the staged shapes of
        ``plan``; C_prev is zero, as on the main path, or random normal from
        ``c0_seed``."""
        torch = self.torch
        mod = self.kernels["ranged_spgemm"]
        a, slabs = self.dense_stage(A, P, plan)
        shape = a.shape[:3] + (P.n_cols,)
        if c0_seed is None:
            c0 = torch.zeros(shape, dtype=torch.float32, device=a.device)
        else:
            gen = torch.Generator(device=a.device).manual_seed(c0_seed)
            c0 = torch.randn(shape, generator=gen, dtype=torch.float32, device=a.device)
        r0s, _ = plan.b_ranges()
        run = lambda order: mod.ranged_spgemm_stream(a, slabs, c0, r0s, order=order)  # noqa: E731
        plain = lambda order: mod.ranged_spgemm_plain(a, slabs, c0, r0s, order=order)  # noqa: E731
        orders = {}
        for order in ORDERS:
            orders[order] = self.hold_dense(f"ranged_spgemm/{label}/{order}", run(order),
                                            plain(order))
            orders[order]["ms"] = self.launch_ms(lambda: run(order))
            orders[order]["wrapper_ms"] = cuda_ms(torch, lambda: run(order))
            if record:
                orders[order]["plain_ms"] = cuda_ms(torch, lambda: plain(order))
        batch, n_ac, strip_rows, k_pad = a.shape
        n_b, span, n = slabs.shape[1:]
        # the work the real rows need: A's rows x its columns, every B row
        # once, C_prev read and C written at A's rows
        moved = 4 * (A.n_rows * A.n_cols + P.n_rows * n + 2 * A.n_rows * n) + 4 * n_b
        flops = 2 * A.n_rows * P.n_rows * n + n_b * A.n_rows * n
        library = (None,) * 4
        if record:
            def baddbmm():
                out = c0[0]
                for j, r0 in enumerate(r0s.tolist()):
                    out = torch.baddbmm(out, a[0, :, :, r0:r0 + span],
                                        slabs[0, j].expand(n_ac, span, n))
                return out
            library = (cuda_ms(torch, baddbmm), *device_ms(torch, baddbmm), None)
        self.finish_phase("ranged_spgemm", label, orders,
                          "chunk2" if plan.algorithm == "chunk2" else "chunk1",
                          moved, flops, library,
                          {"strips": n_ac, "chunks": n_b, "strip_rows": strip_rows,
                           "k_pad": k_pad, "span": span, "n": n,
                           "staged_a_bytes": nbytes(a), "c0": "zero" if c0_seed is None
                           else f"normal(seed={c0_seed})"}, record)
        del a, slabs, c0
        torch.cuda.empty_cache()

    def finish_phase(self, kernel, label, orders, main_order, moved, flops, library,
                     shapes, record, launches_per_call=None) -> None:
        t_bytes = moved / PEAK["bytes_per_s"] * 1e3
        t_ops = flops / PEAK["f32_flops"] * 1e3
        bound = {"bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        library_ms, library_device_ms, library_empty_traces, library_error = library
        err = max(o["max_abs_err"] for o in orders.values())
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), err)
        if record:
            main = orders[main_order]
            self.phase[kernel] = {"ms": main["ms"], "wrapper_ms": main["wrapper_ms"],
                                  "plain_ms": main["plain_ms"], **bound,
                                  "library_ms": library_ms,
                                  "library_device_ms": library_device_ms}
        emit({"kernel_phase": kernel, "label": label, "main_order": main_order,
              "orders": orders, "shapes": shapes, "bytes": moved, "flops": flops, **bound,
              "launches_per_call": launches_per_call,
              "library_ms": library_ms, "library_device_ms": library_device_ms,
              "library_empty_traces": library_empty_traces,
              "library_error": library_error, "peaks_of": PEAK["part"]})

    def edge_phase(self) -> None:
        """Every kernel in both orders against its plain version on the
        full-table geometry: one fully dense C row, so that row's hash table
        has exactly ``n_cols`` slots and fills them all, with a nonzero C_prev
        and A and B cut in thirds (three chunks, three strips)."""
        torch, csr, ch = self.torch, self.m["csr"], self.m["chunking"]
        rng = np.random.default_rng(EDGE_SEED)
        rows, k, n = 96, 32, 128

        def sparse_normal(shape, density):
            vals = rng.standard_normal(shape).astype(np.float32)
            return np.where(rng.random(shape) < density, vals, np.float32(0))
        a, b, c0 = sparse_normal((rows, k), 0.1), sparse_normal((k, n), 0.05), \
            sparse_normal((rows, n), 0.05)
        a[40] = rng.standard_normal(k)   # a dense A row ...
        b[0] = rng.standard_normal(n)    # ... reaching a dense B row
        pattern = ((a != 0).astype(np.int64) @ (b != 0).astype(np.int64) > 0) | (c0 != 0)
        row_cap = int(pattern.sum(1).max())
        table = self.m["planner"].hash_table_slots(row_cap)
        check(row_cap == n and table == n, f"edge geometry: row cap {row_cap}, "
              f"table {table}, expected a full table of {n}")
        A, B, C0m = (csr.csr_from_dense(m, device="cuda") for m in (a, b, c0))
        plan = self.m["planner"].ChunkPlan("chunk1", (0, 32, 64, rows), (0, 11, 22, k),
                                          0.0, 0.0)
        strips = ch.a_strips(A, plan.p_ac)
        c_cap = strips[0].n_rows * n
        Ast = csr.csr_stack([csr.csr_stack(strips)])
        Bst = csr.csr_stack([csr.csr_stack(ch.b_chunks(B, plan.p_b))])
        C0s = csr.csr_stack([csr.csr_pad_to(s, c_cap) for s in ch.a_strips(C0m, plan.p_ac)])
        C0 = csr.csr_stack([C0s])
        r0s, r1s = plan.b_ranges()
        result = {}
        for kernel in ("hash_accum_spgemm", "sparse_accum_spgemm"):
            run, plain = self.csr_runners(kernel, Ast, Bst, C0, r0s, r1s, row_cap)
            result[kernel] = {order: self.hold_csr(f"{kernel}/edge/{order}", run(order),
                                                   plain(order)) for order in ORDERS}
        cs, mod = self.m["chunk_stream"], self.kernels["ranged_spgemm"]
        ad, slabs = self.dense_stage(A, B, plan)
        cd = cs._dense_stack(C0s, levels=1)[None]
        result["ranged_spgemm"] = {order: self.hold_dense(
            f"ranged_spgemm/edge/{order}",
            mod.ranged_spgemm_stream(ad, slabs, cd, r0s, order=order),
            mod.ranged_spgemm_plain(ad, slabs, cd, r0s, order=order)) for order in ORDERS}
        for kernel, orders in result.items():
            self.max_err[kernel] = max(self.max_err.get(kernel, 0.0),
                                       *(o["max_abs_err"] for o in orders.values()))
        emit({"edge_phase": "dense_row_thirds", "shape": [rows, k, n],
              "c_max_row_nnz": row_cap, "table_size": table,
              "nnz_c0": int(C0.indptr[..., -1].sum()), "kernels": result})

    # -- main path ---------------------------------------------------------

    def main_run(self, label: str, name: str, n: int, backend: str, *,
                 budget_div: float = 4.0, knl_div: float | None = None,
                 expect_algorithm: str | None = None,
                 expect_backend: str | None = None) -> None:
        torch = self.torch
        chunking, planner, kkmem = self.m["chunking"], self.m["planner"], self.m["kkmem"]
        A, P = self.problem(name, n)
        t0 = time.perf_counter()
        crb, budget = self.quickstart_inputs(A, P)
        if knl_div is not None:
            limit = float(planner.row_bytes_csr(P).sum()) / knl_div
            plan = planner.plan_knl(A, P, fast_limit_bytes=limit)
        else:
            limit = budget * 4 / budget_div
            plan = planner.plan_chunks(A, P, crb, self.m["memory_model"].P100,
                                       fast_limit_bytes=limit)
        check(plan.algorithm != "whole_fast", f"{label}: whole_fast bypasses every kernel")
        if expect_algorithm:
            check(plan.algorithm == expect_algorithm,
                  f"{label}: plan is {plan.algorithm}, expected {expect_algorithm}")
        caps = self.m["symbolic"].strip_output_caps(A, P, plan.p_ac)
        chosen = backend
        if backend == "auto":
            env = chunking.instance_envelope(A, P, plan, caps=caps)
            chosen = planner.select_accumulator_backend(plan, env)
        if expect_backend:
            check(chosen == expect_backend, f"{label}: auto chose {chosen}, "
                  f"the reference's planner chooses {expect_backend}")
        plan_s = time.perf_counter() - t0

        self.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C, stats = chunking.chunked_spgemm(A, P, plan, backend=backend)
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        launches = self.read_counters()
        kernel = self.backend_kernel.get(chosen)   # scan runs no kernel of its own
        if kernel is not None:
            check(launches[kernel] > 0, f"{label}: {kernel} was not launched")
            self.launches.setdefault(kernel, launches[kernel])

        ws = kkmem.spgemm_symbolic_host(A, P)
        plain = kkmem.spgemm(A, P, ws.c_pad)
        nnz, plain_nnz = C.nnz(), plain.nnz()
        if chosen == "pallas":
            # the dense backend keeps only nonzero sums: compare densified
            d_got, d_want = self.m["csr"].csr_to_dense(C), self.m["csr"].csr_to_dense(plain)
            err = float((d_got - d_want).abs().max())
            structure = nnz <= plain_nnz
            del d_got, d_want
        else:
            structure = (torch.equal(C.indptr, plain.indptr)
                         and torch.equal(C.indices[:nnz], plain.indices[:nnz]))
            err = float((C.data[:nnz] - plain.data[:nnz]).abs().max()) if nnz else 0.0
        check(structure, f"{label}: structure differs from the plain spgemm")
        scale = float(plain.data[:plain_nnz].abs().max())
        check(err <= KERNEL_ATOL + KERNEL_RTOL * scale,
              f"{label}: values differ from the plain spgemm by {err}")
        scipy_err = self.scipy_check(A, P, C)
        check(scipy_err <= SCIPY_RTOL, f"{label}: relative error {scipy_err} vs scipy")
        emit({"run": label, "problem": name, "n": n, "A": list(A.shape),
              "P": list(P.shape), "nnz_A": A.nnz(), "backend": backend,
              "chosen": chosen, "plan": {"algorithm": plan.algorithm,
                                         "n_ac": plan.n_ac, "n_b": plan.n_b,
                                         "fast_limit_bytes": limit},
              "launches": launches, "nnz_C": nnz,
              "stats": {"kernel_calls": stats.kernel_calls,
                        "copy_in_bytes": stats.copy_in_bytes,
                        "copy_out_bytes": stats.copy_out_bytes,
                        "copy_events": len(stats.per_copy_in) + len(stats.per_copy_out)},
              "wall_s": {"problem": self.problems[(name, n)][2], "plan": plan_s,
                         "chunked_spgemm": exec_s},
              "check": {"plain_structure_equal": structure, "plain_max_abs_err": err,
                        "scipy_rel_err": scipy_err}})
        del C, plain
        torch.cuda.empty_cache()

    def breakdown(self, label: str, name: str, n: int, backend: str) -> None:
        """Where one main-path call's time goes, on a repeat of that run:
        cumulative host seconds of the port's stages (cProfile, which slows
        Python code and so inflates the host share a little), then the
        device's busy time (every CUDA activity: kernels, copies, fills) over
        the call's wall time (torch.profiler)."""
        import cProfile
        import pstats

        torch = self.torch
        chunking, planner = self.m["chunking"], self.m["planner"]
        A, P = self.problem(name, n)
        crb, budget = self.quickstart_inputs(A, P)
        plan = planner.plan_chunks(A, P, crb, self.m["memory_model"].P100,
                                   fast_limit_bytes=budget)
        stages = ("chunked_spgemm", "strip_output_caps", "instance_envelope",
                  "a_strips", "b_chunks", "csr_stack", "check_output_caps",
                  "hash_accum_spgemm_stream", "sparse_accum_spgemm_stream",
                  "ranged_spgemm_stream", "_assemble")
        profile = cProfile.Profile()
        torch.cuda.synchronize()
        profile.enable()
        chunking.chunked_spgemm(A, P, plan, backend=backend)
        torch.cuda.synchronize()
        profile.disable()
        host = {}
        for (path, _, fn), row in pstats.Stats(profile).stats.items():
            if fn in stages and "repro_torch" in path:
                host[fn] = max(host.get(fn, 0.0), row[3])
        wall = []

        def call():
            t0 = time.perf_counter()
            chunking.chunked_spgemm(A, P, plan, backend=backend)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        device_ms = device_busy_ms(profiled(torch, call))
        wall_ms = wall[0]
        emit({"breakdown": label, "backend": backend, "plan": plan.algorithm,
              "host_cumulative_s": host, "profiled_wall_ms": wall_ms,
              "device_kernel_ms": device_ms if device_ms > 0 else None,
              "device_busy_share": device_ms / wall_ms if device_ms > 0 else None})

    def scipy_check(self, A, P, C, R=None) -> float:
        """max |C - A @ P| / max |A @ P| (or of ``R @ (A @ P)``) against scipy
        in float64, zeros eliminated on both sides."""
        import scipy.sparse as sp

        def host(m):
            nnz = m.nnz()
            out = sp.csr_matrix((m.data[:nnz].cpu().numpy().astype(np.float64),
                                 m.indices[:nnz].cpu().numpy(),
                                 m.indptr.cpu().numpy()), shape=m.shape)
            out.eliminate_zeros()
            return out
        ref = host(A) @ host(P)
        if R is not None:
            ref = host(R) @ ref
        ref.eliminate_zeros()
        got = host(C)
        scale = abs(ref).max() if ref.nnz else 1.0
        diff = abs(got - ref)
        return float(diff.max() / scale) if diff.nnz else 0.0

    # -- second path: masked products, pipelines, blocked kernels ----------

    def triangle_graph(self):
        """The degree-sorted lower triangle L of the RMAT graph, on the card,
        with its generation seconds and the scipy float64 count of (L L) o L."""
        if not hasattr(self, "_graph"):
            import scipy.sparse as sp

            graphs = self.m["graphs"]
            t0 = time.perf_counter()
            L = graphs.lower_triangular_degree_sorted(
                graphs.rmat(RMAT_SCALE, RMAT_EDGE_FACTOR, seed=RMAT_SEED, device="cuda"))
            self.torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            nnz = L.nnz()
            Ls = sp.csr_matrix((L.data[:nnz].cpu().numpy().astype(np.float64),
                                L.indices[:nnz].cpu().numpy(), L.indptr.cpu().numpy()),
                               shape=L.shape)
            t0 = time.perf_counter()
            want = float((Ls @ Ls).multiply(Ls).sum())
            self._graph = (L, seconds, want, time.perf_counter() - t0)
        return self._graph

    def products(self, A, B) -> int:
        """Scalar products of A x B: the B row length at every A entry."""
        lens = (B.indptr[1:] - B.indptr[:-1]).long()
        return int(lens[A.indices[: A.nnz()].long()].sum())

    def masked_kernel_phase(self, label, A, B, M, plan, main_order, *, c0_from=None,
                            record=False) -> None:
        """The masked kernel in both orders against its plain version on the
        staged operands of ``plan``, both timed."""
        torch, mod = self.torch, self.kernels["hash_masked_accum_spgemm"]
        caps = self.m["symbolic"].masked_output_caps(M, plan.p_ac)
        args, table, _ = self.m["chunk_stream"].stage_hash_masked(
            A, B, M, plan, caps.c_pad, caps, c_prev=c0_from)
        run = lambda order: mod.hash_masked_accum_spgemm_stream(  # noqa: E731
            *args, order=order, table_size=table)
        plain = lambda order: mod.hash_masked_plain(  # noqa: E731
            *args, order=order, table_size=table)
        orders = {}
        for order in ORDERS:
            orders[order] = self.hold_csr(f"hash_masked_accum_spgemm/{label}/{order}",
                                          run(order), plain(order))
            orders[order]["ms"] = self.launch_ms(lambda: run(order))
            orders[order]["wrapper_ms"] = cuda_ms(torch, lambda: run(order))
            orders[order]["plain_ms"] = cuda_ms(torch, lambda: plain(order), reps=3)
        counter = self.counters["hash_masked_accum_spgemm"]
        before = counter.count
        out = run(main_order)
        per_call = counter.count - before
        Ast, Bst, C0, Mst = args[:4]
        m_nnz = int(Mst.indptr[..., -1].sum())
        moved = (live_bytes(Ast) + live_bytes(Bst) + live_bytes(C0)
                 + nbytes(Mst.indptr) + 4 * m_nnz + nbytes(*out) + 8 * len(args[4]))
        flops = 2 * self.products(A, B) + int(C0.indptr[..., -1].sum())
        _, _, meta, global_slots = mod.masked_bins(Mst)
        self.finish_phase("hash_masked_accum_spgemm", label, orders, main_order, moved,
                          flops, (None,) * 4,
                          {"strips": plan.n_ac, "chunks": plan.n_b,
                           "strip_rows": Ast.n_rows, "mask_nnz": m_nnz,
                           "densest_mask_row": int(M.max_row_nnz),
                           "reference_table_slots": table,
                           "bins": [list(b) for b in meta],
                           "global_table_slots": global_slots,
                           "nnz_c0": int(C0.indptr[..., -1].sum())}, record, per_call)

    def masked_edge_phase(self) -> None:
        """A 64 x 48 x 48,000 geometry whose mask rows fall in every bin, one
        of them 40,000 entries (a 65,536-slot table in global memory), with a
        nonzero C_prev, under a 3 x 3 plan and a one-chunk knl plan."""
        csr, planner = self.m["csr"], self.m["planner"]
        rng = np.random.default_rng(EDGE_SEED + 1)
        rows, k, n = 64, 48, 48_000

        def sparse_normal(shape, density):
            vals = rng.standard_normal(shape).astype(np.float32)
            return np.where(rng.random(shape) < density, vals, np.float32(0))
        a, b, c0 = sparse_normal((rows, k), 0.2), sparse_normal((k, n), 0.01), \
            sparse_normal((rows, n), 0.001)
        b[0, :45_000] = rng.standard_normal(45_000)
        a[5, 0], a[9, 0] = 1.5, -0.5
        m = rng.random((rows, n)) < 0.0005
        m[5, rng.choice(n, 40_000, replace=False)] = True
        m[6, :3_000], m[7, :600], m[8, :100], m[9, :20_000] = True, True, True, True
        A, B, M, C0 = (csr.csr_from_dense(x, device="cuda")
                       for x in (a, b, m.astype(np.float32), c0))
        for plan in (planner.ChunkPlan("chunk1", (0, 20, 40, rows), (0, 16, 32, k), 0., 0.),
                     planner.ChunkPlan("knl", (0, rows), (0, k), 0., 0.)):
            self.masked_kernel_phase(f"edge_global_table_{plan.algorithm}", A, B, M, plan,
                                     "chunk1", c0_from=C0)

    def triangle_run(self, label: str, *, chunk2: bool = False) -> None:
        """``count_triangles`` on the RMAT graph's L: the default one-chunk
        knl plan, or a chunk2 plan from ``plan_chunks`` with L's row bytes as
        the C estimate; the count must equal scipy's exactly."""
        torch, planner, tri = self.torch, self.m["planner"], self.m["triangle"]
        L, gen_s, want, scipy_s = self.triangle_graph()
        t0 = time.perf_counter()
        limit = None
        if chunk2:
            # a third of size(A) + size(B) + size(mask) = size(L) plans
            # chunk1; the B-resident chunk2 branch with >= 4 strips needs a
            # limit between 4/3 and 3/2 of size(L)
            size = float(planner.row_bytes_csr(L).sum())
            limit = 1.4 * size
            plan = planner.plan_chunks(L, L, planner.row_bytes_csr(L),
                                       self.m["memory_model"].P100, fast_limit_bytes=limit)
            check(plan.algorithm == "chunk2" and plan.n_ac >= 4,
                  f"{label}: planned {plan.algorithm} {plan.n_ac}x{plan.n_b}")
        else:
            plan = planner.plan_knl(L, L, float("inf"))
        caps = self.m["symbolic"].masked_output_caps(L, plan.p_ac)
        plan_s = time.perf_counter() - t0
        self.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = tri.count_triangles(L, plan=plan, caps=caps)
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        launches = self.read_counters()
        check(launches["hash_masked_accum_spgemm"] > 0,
              f"{label}: the masked kernel was not launched")
        check(got.dtype == torch.float64 and float(got) == want,
              f"{label}: {float(got)} triangles, scipy counts {want}")
        if not chunk2:
            self.launches["hash_masked_accum_spgemm"] = launches["hash_masked_accum_spgemm"]
        emit({"run": label, "graph": f"rmat({RMAT_SCALE}, {RMAT_EDGE_FACTOR}, "
              f"seed={RMAT_SEED}) -> lower_triangular_degree_sorted",
              "L": list(L.shape), "nnz_L": L.nnz(), "densest_row": L.max_row_nnz,
              "products": self.products(L, L),
              "plan": {"algorithm": plan.algorithm, "n_ac": plan.n_ac, "n_b": plan.n_b,
                       "fast_limit_bytes": limit},
              "launches": launches, "triangles": float(got),
              "wall_s": {"problem": gen_s, "plan": plan_s, "count_triangles": exec_s,
                         "scipy_count": scipy_s},
              "check": {"scipy_float64_triangles": want, "equal": float(got) == want}})

    def galerkin_run(self, label: str, backend: str, frac: float, resident: bool) -> None:
        """``pipeline_spgemm`` of brick3d n=48 through ``backend`` at a fast
        limit of ``frac`` x size(A, P, R): structure equal to the port's
        plain two-hop ``spgemm``, values to scipy's R (A P) in float64."""
        torch, planner, symbolic = self.torch, self.m["planner"], self.m["symbolic"]
        pipe, kkmem = self.m["pipeline"], self.m["kkmem"]
        A, P = self.problem("brick3d", 48)
        R = self.restrictions[("brick3d", 48)]
        t0 = time.perf_counter()
        if not hasattr(self, "_pipe_plans"):
            self._pipe_plans = {"t_pattern": symbolic.spgemm_pattern_host(A, P)}
        tp = self._pipe_plans["t_pattern"]
        limit = frac * float(A.nbytes() + P.nbytes() + R.nbytes())
        if frac not in self._pipe_plans:   # one plan per limit, shared by backends
            plan = planner.plan_pipeline(A, P, R, self.m["memory_model"].P100,
                                         fast_limit_bytes=limit, t_pattern=tp)
            caps = symbolic.pipeline_output_caps(A, P, R, plan.plan1.p_ac,
                                                 plan.plan2.p_ac, t_pattern=tp)
            self._pipe_plans[frac] = (plan, caps)
        plan, caps = self._pipe_plans[frac]
        check(plan.t_resident == resident, f"{label}: t_resident={plan.t_resident}")
        check("whole_fast" not in (plan.plan1.algorithm, plan.plan2.algorithm),
              f"{label}: a whole_fast hop bypasses the kernels")
        plan_s = time.perf_counter() - t0
        self.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C, stats = pipe.pipeline_spgemm(A, P, R, plan, backend=backend, caps=caps)
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        launches = self.read_counters()
        kernel = self.backend_kernel[backend]
        check(launches[kernel] > 0, f"{label}: {kernel} was not launched")
        if not hasattr(self, "_rap_plain"):
            self._rap_plain = kkmem.spgemm_full(R, kkmem.spgemm_full(A, P))
        plain = self._rap_plain
        nnz = C.nnz()
        structure = (torch.equal(C.indptr, plain.indptr)
                     and torch.equal(C.indices[:nnz], plain.indices[:nnz]))
        check(structure, f"{label}: structure differs from the plain two-hop spgemm")
        err = float((C.data[:nnz] - plain.data[:nnz]).abs().max()) if nnz else 0.0
        scale = float(plain.data[:nnz].abs().max()) if nnz else 0.0
        check(err <= KERNEL_ATOL + KERNEL_RTOL * scale,
              f"{label}: values differ from the plain two-hop spgemm by {err}")
        scipy_err = self.scipy_check(A, P, C, R=R)
        check(scipy_err <= SCIPY_RTOL, f"{label}: relative error {scipy_err} vs scipy")
        emit({"run": label, "problem": "brick3d", "n": 48, "backend": backend,
              "plan": {"hop1": [plan.plan1.algorithm, plan.plan1.n_ac, plan.plan1.n_b],
                       "hop2": [plan.plan2.algorithm, plan.plan2.n_ac, plan.plan2.n_b],
                       "t_resident": plan.t_resident, "t_bytes": plan.t_bytes,
                       "fast_limit_bytes": limit},
              "launches": launches, "nnz_T": caps.t_nnz, "nnz_C": nnz,
              "stats": {"spilled": stats.spilled, "spill_bytes": stats.spill_bytes,
                        "copy_bytes": stats.copy_bytes,
                        "kernel_calls": [stats.hop1.kernel_calls, stats.hop2.kernel_calls]},
              "wall_s": {"problem": self.problems[("brick3d", 48)][2], "plan": plan_s,
                         "pipeline_spgemm": exec_s},
              "check": {"plain_structure_equal": structure, "plain_max_abs_err": err,
                        "scipy_rel_err": scipy_err}})

    def bsr_pairs(self, A, P, plan):
        """The (strip, chunk) pairs the ``bsr`` executor stages, as kernel
        operands and metas, with the envelope that capped them."""
        caps = self.m["symbolic"].strip_output_caps(A, P, plan.p_ac)
        env = self.m["chunking"].instance_envelope(A, P, plan, caps=caps,
                                                   block_size=BSR_BLOCK)
        pairs = [(ops, meta) for _, ops, meta
                 in self.m["chunk_stream"].stage_bsr_pairs(A, P, plan, env)]
        return pairs, env

    def hold_tiles(self, what: str, got, want) -> float:
        self.torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        check(bool(self.torch.allclose(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)),
              f"{what}: values differ from the plain version by {err}")
        return err

    def bsr_kernel_phase(self, A, P, plan, *, label: str, record: bool = False) -> None:
        """The BSR x BSR kernel on every staged pair of the ``bsr`` run,
        against its plain version, in f32 and, on the first pair, on the same
        blocks in bf16."""
        torch, mod = self.torch, self.kernels["bsr_spgemm"]
        pairs, env = self.bsr_pairs(A, P, plan)
        _, _, _, nc, u = env.bsr_caps
        run = lambda: [mod.bsr_spgemm_blocks(*ops, nc, u, BSR_BLOCK)  # noqa: E731
                       for ops, _ in pairs]
        plain = lambda: [mod.bsr_spgemm_plain(*ops, nc, u, BSR_BLOCK)  # noqa: E731
                         for ops, _ in pairs]
        err = max(self.hold_tiles(f"bsr_spgemm/{label}/pair{i}", g, w)
                  for i, (g, w) in enumerate(zip(run(), plain())))
        a, b, sa, sb = pairs[0][0]
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        err16 = self.hold_tiles(f"bsr_spgemm/{label}/bf16",
                                mod.bsr_spgemm_blocks(a16, b16, sa, sb, nc, u, BSR_BLOCK),
                                mod.bsr_spgemm_plain(a16, b16, sa, sb, nc, u, BSR_BLOCK))
        numbers = {"max_abs_err": max(err, err16), "bf16_max_abs_err": err16,
                   "ms": self.launch_ms(run), "wrapper_ms": cuda_ms(torch, run)}
        if record:
            numbers["plain_ms"] = cuda_ms(torch, plain, reps=3)
        # each pair reads the live blocks its slot tables name and one
        # (a slot, b slot) pair of int32 per contributor pair, once, and
        # writes its real output tiles once
        bs2 = BSR_BLOCK * BSR_BLOCK * 4
        moved = flops = 0
        for (a, b, _, _), meta in pairs:
            live_a = np.unique(meta.a_slots[meta.a_slots < a.shape[0] - 1]).size
            live_b = np.unique(meta.b_slots[meta.b_slots < b.shape[0] - 1]).size
            contributors = meta.flops // (2 * BSR_BLOCK ** 3)
            moved += (live_a + live_b) * bs2 + 8 * contributors + meta.n_c_blocks * bs2
            flops += meta.flops
        library = self.library_spgemm(A, P) if record else (None,) * 4
        self.finish_phase("bsr_spgemm", label, {"chunk2": numbers}, "chunk2", moved,
                          flops, library,
                          {"block": BSR_BLOCK, "pairs": len(pairs),
                           "bsr_caps": list(env.bsr_caps),
                           "c_blocks": [meta.n_c_blocks for _, meta in pairs]},
                          record, len(pairs))

    def spmm_inputs(self):
        if not hasattr(self, "_spmm"):
            A, _ = self.problem("brick3d", 48)
            t0 = time.perf_counter()
            Ab = self.m["bsr"].bsr_from_csr(A, BSR_BLOCK)
            gen = self.torch.Generator(device="cuda").manual_seed(SPMM_SEED)
            X = self.torch.randn(A.n_cols, SPMM_COLS, generator=gen, device="cuda")
            self._spmm = (A, Ab, X, time.perf_counter() - t0)
        return self._spmm

    def spmm_kernel_phase(self, *, label: str, record: bool = False) -> None:
        """The BSR x dense kernel at the ``bsr_spmm`` run's shapes against its
        plain version."""
        torch, mod, ops = self.torch, self.kernels["bsr_spmm"], self.m["ops"]
        A, Ab, X, _ = self.spmm_inputs()
        meta = mod.bsr_spmm_symbolic(Ab)
        blocks = ops._with_zero_block(Ab.blocks)
        sl = torch.from_numpy(meta.a_slots).cuda()
        co = torch.from_numpy(meta.a_cols).cuda()
        run = lambda: mod.bsr_spmm_blocks(blocks, X, sl, co, Ab.mb, meta.u_max,  # noqa: E731
                                          BSR_BLOCK, SPMM_COLS)
        plain = lambda: mod.bsr_spmm_plain(blocks, X, sl, co, Ab.mb, meta.u_max,  # noqa: E731
                                           BSR_BLOCK)
        numbers = {"max_abs_err": self.hold_tiles(f"bsr_spmm/{label}", run(), plain()),
                   "ms": self.launch_ms(run), "wrapper_ms": cuda_ms(torch, run)}
        if record:
            numbers["plain_ms"] = cuda_ms(torch, plain, reps=3)
        n_blocks = Ab.n_blocks()
        moved = (n_blocks * BSR_BLOCK * BSR_BLOCK * 4 + nbytes(sl, co) + nbytes(X)
                 + Ab.mb * BSR_BLOCK * SPMM_COLS * 4)
        flops = meta.flops * SPMM_COLS
        library = (None,) * 4
        if record:
            values = Ab.blocks[:n_blocks]
            t = torch.sparse_bsr_tensor(Ab.block_indptr, Ab.block_indices[:n_blocks],
                                        values, size=Ab.shape)
            fn = lambda: t @ X  # noqa: E731
            try:
                library = (cuda_ms(torch, fn), *device_ms(torch, fn), None)
            except RuntimeError as err:   # torch refuses: record why, time nothing
                library = (None, None, None, str(err).splitlines()[0])
        self.finish_phase("bsr_spmm", label, {"dense_x": numbers}, "dense_x", moved,
                          flops, library,
                          {"block": BSR_BLOCK, "mb": Ab.mb, "u_max": meta.u_max,
                           "n_blocks": n_blocks, "x": list(X.shape), "bn": SPMM_COLS},
                          record, 1)

    def bsr_run(self, label: str) -> None:
        """``chunked_spgemm(backend="bsr")`` of brick3d n=48 under the
        quickstart plan: values to scipy's A P in float64, zeros removed."""
        torch, planner = self.torch, self.m["planner"]
        A, P = self.problem("brick3d", 48)
        t0 = time.perf_counter()
        crb, budget = self.quickstart_inputs(A, P)
        plan = planner.plan_chunks(A, P, crb, self.m["memory_model"].P100,
                                   fast_limit_bytes=budget)
        plan_s = time.perf_counter() - t0
        self.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C, stats = self.m["chunking"].chunked_spgemm(A, P, plan, backend="bsr")
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        launches = self.read_counters()
        check(launches["bsr_spgemm"] > 0, f"{label}: bsr_spgemm was not launched")
        self.launches["bsr_spgemm"] = launches["bsr_spgemm"]
        scipy_err = self.scipy_check(A, P, C)
        check(scipy_err <= SCIPY_RTOL, f"{label}: relative error {scipy_err} vs scipy")
        emit({"run": label, "problem": "brick3d", "n": 48, "backend": "bsr",
              "block": BSR_BLOCK, "plan": {"algorithm": plan.algorithm, "n_ac": plan.n_ac,
                                           "n_b": plan.n_b},
              "launches": launches, "nnz_C": C.nnz(),
              "stats": {"kernel_calls": stats.kernel_calls,
                        "copy_in_bytes": stats.copy_in_bytes},
              "wall_s": {"problem": self.problems[("brick3d", 48)][2], "plan": plan_s,
                         "chunked_spgemm": exec_s},
              "check": {"scipy_rel_err": scipy_err}})

    def spmm_run(self, label: str) -> None:
        """``ops.bsr_spmm`` of brick3d n=48 as BSR by a seeded dense X:
        values to scipy's A X in float64."""
        import scipy.sparse as sp

        torch, ops = self.torch, self.m["ops"]
        A, Ab, X, stage_s = self.spmm_inputs()
        self.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Y = ops.bsr_spmm(Ab, X, bn=SPMM_COLS)
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        launches = self.read_counters()
        check(launches["bsr_spmm"] > 0, f"{label}: bsr_spmm was not launched")
        self.launches["bsr_spmm"] = launches["bsr_spmm"]
        nnz = A.nnz()
        As = sp.csr_matrix((A.data[:nnz].cpu().numpy().astype(np.float64),
                            A.indices[:nnz].cpu().numpy(), A.indptr.cpu().numpy()),
                           shape=A.shape)
        ref = As @ X.cpu().numpy().astype(np.float64)
        got = Y.cpu().numpy().astype(np.float64)
        check(got.shape == ref.shape and np.isfinite(got).all(), f"{label}: bad output")
        rel = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))
        check(rel <= SCIPY_RTOL, f"{label}: relative error {rel} vs scipy")
        emit({"run": label, "problem": "brick3d", "n": 48, "block": BSR_BLOCK,
              "A": list(A.shape), "X": list(X.shape), "n_blocks": Ab.n_blocks(),
              "launches": launches,
              "wall_s": {"problem": self.problems[("brick3d", 48)][2],
                         "plan": stage_s, "bsr_spmm": exec_s},
              "check": {"scipy_rel_err": rel}})

    def kernels_line(self) -> None:
        rows = []
        for kernel, numbers in self.phase.items():
            check(self.launches.get(kernel, 0) > 0,
                  f"{kernel}: launched no time on its main-path run")
            rows.append({"name": kernel, "route": "cuda",
                         "source": f"src/repro_torch/kernels/csrc/{kernel}.cu",
                         "replaces": REPLACES[kernel],
                         "launches": self.launches[kernel],
                         "max_abs_err": self.max_err[kernel], **numbers})
        check(len(rows) == len(self.kernels), "a kernel phase is missing")
        emit({"kernels": rows})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is missing; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke(torch)
    smoke.card()
    smoke.build()

    # kernel phases at the shapes the main path stages (quickstart budget,
    # chunk2 6x1: these numbers go into the kernels line), then at the chunk1
    # 15x4 plans with a nonzero C_prev, then on the full-table edge geometry
    planner, mm = smoke.m["planner"], smoke.m["memory_model"]
    A48, P48 = smoke.problem("brick3d", 48)
    crb, budget = smoke.quickstart_inputs(A48, P48)
    plan48 = planner.plan_chunks(A48, P48, crb, mm.P100, fast_limit_bytes=budget)
    plan48c1 = planner.plan_chunks(A48, P48, crb, mm.P100, fast_limit_bytes=budget / 3)
    check(plan48c1.algorithm == "chunk1" and plan48c1.n_b > 1,
          f"brick3d48 at budget/3 plans {plan48c1.algorithm} x{plan48c1.n_b}")
    order48 = "chunk2" if plan48.algorithm == "chunk2" else "chunk1"
    for kernel in ("hash_accum_spgemm", "sparse_accum_spgemm"):
        smoke.csr_kernel_phase(kernel, A48, P48, plan48, order48,
                               label="brick3d48_quickstart", record=True)
        smoke.csr_kernel_phase(kernel, A48, P48, plan48c1, "chunk1",
                               label="brick3d48_chunk1_c0", c0_from=P48)
    A32, P32 = smoke.problem("brick3d", 32)
    crb32, budget32 = smoke.quickstart_inputs(A32, P32)
    plan32 = planner.plan_chunks(A32, P32, crb32, mm.P100, fast_limit_bytes=budget32)
    smoke.dense_kernel_phase(A32, P32, plan32, label="brick3d32_quickstart", record=True)
    plan32c1 = planner.plan_chunks(A32, P32, crb32, mm.P100, fast_limit_bytes=budget32 / 3)
    check(plan32c1.n_b > 1, f"brick3d32 at budget/3 plans {plan32c1.n_b} chunk")
    smoke.dense_kernel_phase(A32, P32, plan32c1, label="brick3d32_chunk1_c0",
                             c0_seed=EDGE_SEED)
    smoke.edge_phase()

    # the main path, counters reset before each run
    smoke.main_run("brick3d48_auto", "brick3d", 48, "auto", expect_backend="hash")
    smoke.main_run("brick3d48_sparse", "brick3d", 48, "sparse")
    smoke.main_run("brick3d48_scan", "brick3d", 48, "scan")
    smoke.main_run("brick3d48_knl_hash", "brick3d", 48, "hash", knl_div=3,
                   expect_algorithm="knl")
    smoke.main_run("brick3d48_chunk1_auto", "brick3d", 48, "auto", budget_div=12,
                   expect_algorithm="chunk1")
    smoke.main_run("brick3d48_chunk1_sparse", "brick3d", 48, "sparse", budget_div=12,
                   expect_algorithm="chunk1")
    smoke.main_run("laplace3d64_auto", "laplace3d", 64, "auto")
    smoke.main_run("elasticity24_auto", "elasticity", 24, "auto")
    smoke.main_run("brick3d32_pallas", "brick3d", 32, "pallas")
    smoke.breakdown("brick3d48_auto", "brick3d", 48, "auto")

    # the second path: its kernels against their plain versions (main-run
    # shapes first: these numbers go into the kernels line), then its runs
    L = smoke.triangle_graph()[0]
    smoke.masked_kernel_phase("tc_rmat18_knl", L, L, L, planner.plan_knl(L, L, float("inf")),
                              "chunk1", record=True)
    graphs, csr = smoke.m["graphs"], smoke.m["csr"]
    L12 = graphs.lower_triangular_degree_sorted(
        graphs.rmat(12, RMAT_EDGE_FACTOR, seed=RMAT_SEED, device="cuda"))
    n12 = L12.n_rows
    thirds = (0, n12 // 3, 2 * n12 // 3, n12)
    smoke.masked_kernel_phase("tc_rmat12_knl", L12, L12, L12,
                              planner.plan_knl(L12, L12, float("inf")), "chunk1")
    gen = torch.Generator(device="cuda").manual_seed(EDGE_SEED)
    c0 = torch.rand(n12, n12, generator=gen, device="cuda")
    c0 = torch.where(c0 < 0.01, c0, 0.0).tril(-1)   # partly inside L's mask
    smoke.masked_kernel_phase("tc_rmat12_3x3_c0", L12, L12, L12,
                              planner.ChunkPlan("chunk2", thirds, thirds, 0.0, 0.0),
                              "chunk2", c0_from=csr.csr_from_dense(c0, device="cuda"))
    smoke.masked_edge_phase()
    smoke.bsr_kernel_phase(A48, P48, plan48, label="brick3d48_bsr", record=True)
    smoke.spmm_kernel_phase(label="bsr_spmm_brick3d48", record=True)

    smoke.triangle_run("tc_rmat18_fused")
    smoke.triangle_run("tc_rmat18_chunk2", chunk2=True)
    for backend in ("hash", "sparse"):
        smoke.galerkin_run(f"galerkin_brick3d48_{backend}_resident", backend,
                           PIPE_RESIDENT, True)
        smoke.galerkin_run(f"galerkin_brick3d48_{backend}_spill", backend, PIPE_SPILL, False)
    smoke.bsr_run("brick3d48_bsr")
    smoke.spmm_run("bsr_spmm_brick3d48")
    smoke.kernels_line()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
