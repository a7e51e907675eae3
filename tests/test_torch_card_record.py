"""``chip_smoke.py``'s record of the kernels, by its host side.

No card runs here, so the profiler and the kernels line are fed by hand:

* ``err_key``: a routed kernel's errors are keyed by route, operand dtype
  and (for the grouped GEMM's fma route) tiling, whatever name the dtype
  comes under.
* ``kernel_device_split``: the median over the complete traces, and for
  every incomplete trace what it held (activities, matched names) in place
  of the matching the kernel's row is timed by.
* ``Smoke.kernels_line``: the grouped GEMM's f32 rows carry the f32 error
  and the launches of their own tiling, the bf16 operands through that
  tiling a field of their own, and every other row its route's numbers.
"""

import json

import pytest
import torch

import chip_smoke


@pytest.mark.parametrize(("args", "want"), [
    (("grouped_matmul", "fma", torch.float32, "tile"), "grouped_matmul/fma/float32/tile"),
    (("grouped_matmul", "fma", torch.bfloat16, "rows_few"),
     "grouped_matmul/fma/bfloat16/rows_few"),
    (("grouped_matmul", "tile", "bfloat16"), "grouped_matmul/tile/bfloat16"),
    (("flash_prefill", "fma", "f32"), "flash_prefill/fma/float32"),
    (("flash_prefill", "tc", "bf16"), "flash_prefill/tc/bfloat16"),
])
def test_err_key(args, want):
    assert chip_smoke.err_key(*args) == want


def test_kernel_device_split_records_incomplete_traces(monkeypatch):
    name = "void ffma::flash_prefill_kernel<64>(float const*)"
    traces = iter([{}, {name: (4.0, 1)}, {"other": (1.0, 3)}, {}, {}, {}, {}, {name: (4.2, 1)},
                   {name: (2.0, 1), "x flash_prefill_kernel y": (2.0, 1)}, {name: (4.1, 1)}])
    monkeypatch.setattr(chip_smoke, "profiled", lambda torch_, fn: None)
    monkeypatch.setattr(chip_smoke, "device_by_name", lambda prof: next(traces))

    class Torch:
        class cuda:
            synchronize = staticmethod(lambda: None)
    median, incomplete, split, held = chip_smoke.kernel_device_split(
        Torch, lambda: None, ("flash_prefill_kernel",), 1, reps=3, tries=10)
    assert (median, incomplete) == (4.1, 7)
    assert split == {"flash_prefill_kernel": 4.1}
    empty = {"activities": 0, "busy_ms": 0, "matched": {}, "top": {}}
    assert held == [
        empty,
        {"activities": 3, "busy_ms": 1.0, "matched": {}, "top": {"other": [1.0, 3]}},
        empty, empty, empty, empty,
        {"activities": 2, "busy_ms": 4.0, "matched": {name: 1, "x flash_prefill_kernel y": 1},
         "top": {name: [2.0, 1], "x flash_prefill_kernel y": [2.0, 1]}}]


def test_kernels_line_keys_fma_rows_by_tiling(monkeypatch):
    smoke = chip_smoke.Smoke(torch)
    for kernel in smoke.kernels:   # a routed kernel's rows come from its route rows
        smoke.phase[kernel] = {"ms": 1.0}
        smoke.launches[kernel] = 1
        smoke.max_err[kernel] = 1e-6
    key = chip_smoke.err_key
    rows = {("flash_prefill", "tc", "serve_prefill"): "bf16",
            ("flash_prefill", "fma", "serve_prefill"): "f32",
            ("grouped_matmul", "tile", "prefill"): "bfloat16",
            ("grouped_matmul", "small", "decode"): "bfloat16",
            ("grouped_matmul", "fma", "prefill"): "float32",
            ("grouped_matmul", "fma", "decode"): "float32",
            ("sparse_accum_spgemm", "shared", "brick3d48_quickstart"): "float32",
            ("sparse_accum_spgemm", "global", "rmat12_knl"): "float32"}
    tilings = {"prefill": "tile", "decode": "rows_few"}
    for (kernel, route, shape), dtype in rows.items():
        row = {"ms": 1.0, "dtype": dtype}
        if route == "fma" and kernel == "grouped_matmul":
            row["fma_tiling"] = tilings[shape]
        smoke.route_rows[kernel, route, shape] = row
    smoke.route_runs = {"flash_prefill/tc": ("serve", 16), "flash_prefill/fma": ("f32", 16),
                        "grouped_matmul/tile": ("serve", 48),
                        "grouped_matmul/small": ("serve", 1488),
                        "grouped_matmul/fma": ("f32", 1536),
                        "grouped_matmul/fma/tile": ("f32", 48),
                        "grouped_matmul/fma/rows_few": ("f32", 1488),
                        "sparse_accum_spgemm/shared": ("brick3d48_sparse", 1),
                        "sparse_accum_spgemm/warp128": ("rmat12_sparse", 4),
                        "sparse_accum_spgemm/block512": ("rmat12_sparse", 4),
                        "sparse_accum_spgemm/block2048": ("rmat12_sparse", 4),
                        "sparse_accum_spgemm/block16384": ("rmat12_sparse", 4),
                        "sparse_accum_spgemm/global": ("rmat12_sparse", 2)}
    smoke.max_err = {**smoke.max_err,
                     key("flash_prefill", "tc", "bf16"): 4e-3,
                     key("flash_prefill", "fma", "f32"): 9e-7,
                     key("grouped_matmul", "tile", "bfloat16"): 3e-2,
                     key("grouped_matmul", "small", "bfloat16"): 3e-2,
                     key("grouped_matmul", "fma", "float32", "tile"): 8.1e-6,
                     key("grouped_matmul", "fma", "float32", "rows_few"): 9.5e-7,
                     key("grouped_matmul", "fma", "bfloat16", "tile"): 1.6e-2,
                     key("grouped_matmul", "fma", "bfloat16", "rows_few"): 7.8e-3,
                     key("sparse_accum_spgemm", "shared", "float32"): 1.1e-5,
                     key("sparse_accum_spgemm", "global", "float32"): 2.2e-5}
    smoke.batched["sparse_accum_spgemm"] = {"width": 8, "max_abs_err": 1e-6}
    smoke.batched_launches["sparse_accum_spgemm"] = 1
    lines = []
    monkeypatch.setattr(chip_smoke, "emit", lambda obj: lines.append(json.loads(json.dumps(obj))))
    smoke.kernels_line()
    (line,) = lines
    got = {(r["name"], r.get("kernel_route"), r.get("shape")): r for r in line["kernels"]}
    fma_pre = got["grouped_matmul", "fma", "prefill"]
    fma_dec = got["grouped_matmul", "fma", "decode"]
    assert (fma_pre["launches"], fma_pre["max_abs_err"], fma_pre["bf16_operands_max_abs_err"]) \
        == (48, 8.1e-6, 1.6e-2)
    assert (fma_dec["launches"], fma_dec["max_abs_err"], fma_dec["bf16_operands_max_abs_err"]) \
        == (1488, 9.5e-7, 7.8e-3)
    assert (got["grouped_matmul", "small", "decode"]["launches"],
            got["grouped_matmul", "small", "decode"]["max_abs_err"]) == (1488, 3e-2)
    assert got["flash_prefill", "fma", "serve_prefill"]["max_abs_err"] == 9e-7
    assert "bf16_operands_max_abs_err" not in got["flash_prefill", "fma", "serve_prefill"]
    assert got["bsr_spmm", None, None]["launches"] == 1
    # the ESC kernel's rows by route: the shared route at the main path's
    # staging, the classed call (under its global class) at L x L of an
    # RMAT scale-12 graph, with every class's launches in that run
    esc_global = got["sparse_accum_spgemm", "global", "rmat12_knl"]
    assert (esc_global["launches"], esc_global["launches_run"], esc_global["max_abs_err"]) \
        == (2, "rmat12_sparse", 2.2e-5)
    assert esc_global["class_launches"] == {"warp128": 4, "block512": 4, "block2048": 4,
                                            "block16384": 4, "global": 2}
    assert ("sparse_accum_spgemm", "warp128", "rmat12_knl") not in got
    assert got["sparse_accum_spgemm", "shared", "brick3d48_quickstart"]["max_abs_err"] == 1.1e-5
    assert esc_global["batched"]["launches"] == 1
