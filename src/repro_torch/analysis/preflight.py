"""Preflight of a staged launch against the limits of the card.

The JAX package linted its Pallas kernel bodies for Mosaic lowering
(``analysis/mosaic_lint.py``); Mosaic has no Hopper meaning. What a launch
on the H100 must satisfy is checked here, on the staged operands, before
any kernel runs, as :class:`LintDiagnostic` with the reference's three
severities:

* **errors** (audit violations): a float64 or int64 kernel operand (the
  kernels take float32 values and int32 indices), an index table wider than
  int32 (r0s/r1s, the BSR slot tables, a table size or row width past
  2^31 - 1), and a shared-memory request over a block's limit
  (:mod:`repro_torch.analysis.smem`);
* **info**: the path each host-side chooser takes at the geometry —
  ``ranged_spgemm.choose_path`` (and why its 16-byte-aligned vector path
  was not taken), the ESC merge's launch (``esc_launch_plan``: the shared
  route, or the steps, launches and shared memory of each step class), and
  ``bsr_spmm.choose_path`` of the staged A blocks against a dense operand
  as wide as B (and why its group path was not taken).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import bsr_spmm, ranged_spgemm, sparse_accum_spgemm
from repro_torch.kernels.sparse_accum_spgemm import SMEM_PER_BLOCK
from repro_torch.sparse.csr import CSR

SEVERITIES = ("error", "warning", "info")
INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class LintDiagnostic:
    """One structured finding. ``where`` locates it (operand or chooser);
    ``check`` names the rule."""

    severity: str
    check: str
    where: str
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def describe(self) -> str:
        return f"[{self.severity}] {self.check} @ {self.where}: {self.message}"


def _leaves(value, where: str):
    """(where, tensor or array) of every array in a staged operand tree."""
    if isinstance(value, CSR):
        for f in ("indptr", "indices", "data"):
            yield from _leaves(getattr(value, f), f"{where}.{f}")
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            yield from _leaves(v, f"{where}[{i}]")
    elif isinstance(value, (torch.Tensor, np.ndarray)):
        yield where, value


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def operand_diags(target) -> list:
    """float64/int64 operands and index tables wider than int32."""
    diags = []
    for i, arg in enumerate(target.args):
        for where, t in _leaves(arg, f"arg{i}"):
            name = _dtype_name(t)
            if name == "float64":
                diags.append(LintDiagnostic(
                    "error", "dtype", where,
                    "float64 kernel operand — the kernels compute in float32"))
            elif name in ("int64", "uint64"):
                diags.append(LintDiagnostic(
                    "error", "dtype", where,
                    f"{name} kernel operand — the kernels take int32 indices"))
    tables = [(f"scalar_args[{i}]", t)
              for i, t in enumerate(target.meta.get("scalar_args", ()))]
    for where, t in tables:
        values = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        if values.size and (values.max() > INT32_MAX or values.min() < -INT32_MAX - 1):
            diags.append(LintDiagnostic(
                "error", "table-width", where,
                f"index table holds {values.max()} — wider than int32"))
    for name in ("table_size", "row_cap"):
        size = target.meta.get(name)
        if size is not None and int(size) > INT32_MAX:
            diags.append(LintDiagnostic(
                "error", "table-width", name, f"{name} {size} is wider than int32"))
    return diags


def smem_diags(requests) -> list:
    return [LintDiagnostic(
        "error", "shared-memory", f"{r['source']}/{r['kernel']}",
        f"asks for {r['total']} B of shared memory, more than the {SMEM_PER_BLOCK} "
        "a block has") for r in requests if r["total"] > SMEM_PER_BLOCK]


def _dense_path(target) -> LintDiagnostic:
    """``ranged_spgemm.choose_path`` at the dense staging the core makes."""
    from repro_torch.core.chunk_stream import _dense_stack

    Ast, Bst, r0s = target.args
    strips = Ast.indptr.dim() == 2
    a = _dense_stack(Ast, levels=int(strips), pad_cols=Bst.n_rows)
    a = a[None] if strips else a[None, None]
    slabs = _dense_stack(Bst, levels=1)[None]
    c0 = torch.zeros(a.shape[:3] + (Bst.n_cols,), dtype=torch.float32, device=a.device)
    path = ranged_spgemm.choose_path(a, slabs, c0, r0s)
    msg = f"dense slab path {path!r}"
    if path != "vec":
        k_pad, (span, n) = a.shape[-1], slabs.shape[-2:]
        why = [f"{name}={v} is not a multiple of 4"
               for name, v in (("k_pad", k_pad), ("span", span), ("n", n)) if v % 4]
        why += [f"chunk start {int(r)} is not a multiple of 4"
                for r in np.asarray(r0s) if int(r) % 4]
        why += [f"{name} does not start on 16 bytes" for name, t in
                (("A", a), ("B slabs", slabs), ("C_prev", c0)) if t.data_ptr() % 16]
        msg += f": the 16-byte vector path needs {'; '.join(why)}"
    return LintDiagnostic("info", "chooser", "ranged_spgemm.choose_path", msg)


def _esc_route(target) -> LintDiagnostic:
    plan = sparse_accum_spgemm.esc_launch_plan(*target.args,
                                               row_cap=target.fn.keywords["row_cap"])
    if not plan.split:
        msg = (f"every step on the shared route (the launch-wide bound, "
               f"{plan.work_cap} sort slots, fits shared memory)")
    else:
        msg = (f"steps by class {plan.routes}, launches by class {plan.launches}, "
               f"shared memory a block by class "
               f"{ {c.name: c.block_smem for c in plan.classes} }, "
               f"the global workspace {plan.workspace_bytes} B")
    return LintDiagnostic("info", "chooser", "sparse_accum_spgemm.esc_launch_plan", msg)


def _spmm_path(target) -> LintDiagnostic:
    a_blocks, b_blocks = target.args[0], target.args[1]
    env = target.fn.keywords["envelope"]
    bs = env.bsr_caps[0]
    x = torch.zeros(b_blocks.shape[0] * bs, env.b_shape[1], dtype=torch.float32,
                    device=a_blocks.device)
    path = bsr_spmm.choose_path(a_blocks, x, bs, bsr_spmm.GROUP_COLS)
    msg = f"BSR x dense path {path!r} for the staged A blocks by a dense operand of width {x.shape[1]}"
    if path != "group":
        why = []
        if bs not in bsr_spmm.GROUP_BLOCKS:
            why.append(f"block size {bs} outside {bsr_spmm.GROUP_BLOCKS}")
        if x.shape[1] % 4:
            why.append(f"width {x.shape[1]} is not a multiple of 4")
        if a_blocks.data_ptr() % 16 or x.data_ptr() % 16:
            why.append("an operand does not start on 16 bytes")
        msg += f": the group path needs {'; '.join(why)}"
    return LintDiagnostic("info", "chooser", "bsr_spmm.choose_path", msg)


def chooser_diags(spec_name: str, target) -> list:
    if spec_name == "pallas":
        return [_dense_path(target)]
    if spec_name == "sparse":
        return [_esc_route(target)]
    if spec_name == "bsr":
        return [_spmm_path(target)]
    return []


def check_preflight(spec_name: str, target, requests=()) -> tuple:
    """Audit entry: ``(violations, info)``. Violations are the error-level
    diagnostics' descriptions; ``info`` carries every diagnostic (dicts)
    plus per-severity counts for the report."""
    diags = operand_diags(target) + smem_diags(requests) + chooser_diags(spec_name, target)
    counts = {sev: 0 for sev in SEVERITIES}
    for d in diags:
        counts[d.severity] += 1
    violations = [d.describe() for d in diags if d.severity == "error"]
    return violations, {"checked": True, "counts": counts,
                        "diagnostics": [d.to_dict() for d in diags]}
