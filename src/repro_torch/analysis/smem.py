"""Shared-memory audit: the planner's byte model against one staged step,
and each launch's shared-memory request against a block's limit.

The counterpart of the JAX package's VMEM auditor (``analysis/vmem.py``),
with two checks:

* **Domination.** The spec's ``byte_model(plan, envelope)
  .fast_bytes_needed`` must be at least the bytes of one step as the
  executor stages it, from the copy events the kernels' plain versions
  record (:func:`~repro_torch.analysis.traffic.traced_flows`): per logical
  operand its largest staged piece (the three fields of a CSR piece
  together), the C block once (the output block starts from C_prev and the
  two are never both live: the alias credit), and the kernel's largest step
  workspace (the ESC merge's keys and values of a strip's step, the hash
  tables of a strip, the BSR slot tables and tile). An undercounting model
  is the planner-undercount bug class.
* **Fit.** The shared memory each launch asks for (the wrapper's dynamic
  bytes, from the same arithmetic the wrapper launches with, plus the
  kernel's static bytes in ``_build.BUILD_LOG[source]["kernels"]`` where the
  card built it) must fit ``SMEM_PER_BLOCK`` (232,448 B on the H100).

The scan backend registers no byte model and launches no kernel; its record
says so.
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels import bsr_spgemm, hash_accum_spgemm, sparse_accum_spgemm
from repro_torch.kernels.sparse_accum_spgemm import SMEM_PER_BLOCK, block_smem

_C_KEYS = ("c_prev", "c_out", "c_blocks")


@dataclasses.dataclass(frozen=True)
class SmemAudit:
    """Shared-memory accounting of one core at one geometry."""

    step_bytes: float            # one staged step: pieces + C block + workspace
    model_bytes: float | None    # the byte model's claim (None: no model)
    piece_bytes: float           # the largest staged piece of each operand, summed
    c_bytes: float               # the C block (C_prev and C_out aliased)
    workspace_bytes: float       # the kernel's largest step workspace
    requests: tuple              # per launched kernel: its shared-memory request
    n_launches: int

    @property
    def dominated(self) -> bool | None:
        """model >= step; None when there is no model to check."""
        if self.model_bytes is None:
            return None
        return self.model_bytes >= self.step_bytes

    @property
    def over_limit(self) -> list:
        return [r for r in self.requests if r["total"] > SMEM_PER_BLOCK]


def _key(label: str) -> str:
    return label.split(".")[0]


def step_bytes(launch) -> tuple:
    """(pieces, C block, workspace) bytes of one step of a recorded launch."""
    pieces, c = {}, {}
    for side in (launch.inputs, launch.outputs):
        for label, events in side:
            top = max(events, default=0.0)
            if _key(label) in _C_KEYS:
                field = label.partition(".")[2]
                c[field] = max(c.get(field, 0.0), top)   # C_prev and C_out alias
            else:
                pieces[_key(label)] = pieces.get(_key(label), 0.0) + top
    return sum(pieces.values()), sum(c.values()), float(launch.workspace)


def _static_smem(build_log: dict, source: str, kernel: str) -> int | None:
    """The static shared memory ptxas gave ``kernel`` in ``source``'s
    build, or None where the card has not built it."""
    entries = build_log.get(source, {}).get("kernels", {})
    found = [res["smem_bytes"] for name, res in entries.items() if kernel in name]
    return max(found) if found else None


def launch_requests(target, launches, build_log: dict | None = None) -> list:
    """The shared memory each kernel of the target's launches asks for:
    ``{"source", "kernel", "dynamic", "static", "total"}``, the dynamic
    bytes from the wrapper's own arithmetic at the staged operands."""
    build_log = build_log or {}
    statics = target.fn.keywords
    out = []
    for launch in launches:
        if launch.kernel == "ranged_spgemm":
            kernels = [("ranged_dense_kernel", 0)]
        elif launch.kernel == "sparse_accum_spgemm":
            plan = sparse_accum_spgemm.esc_launch_plan(*target.args,
                                                       row_cap=statics["row_cap"])
            if plan.split:   # each class that launches, at its own shared memory
                kernels = [(c.kernel, c.smem) for c in plan.classes if c.name in plan.launches]
            else:
                kernels = [("accum_rows_kernel", block_smem(plan.smem_per_warp))]
        elif launch.kernel == "hash_accum_spgemm":
            table = hash_accum_spgemm.table_smem(statics["table_size"])
            kernels = [("accum_rows_kernel", block_smem(table))]
        elif launch.kernel == "bsr_spgemm":
            bs = statics["envelope"].bsr_caps[0]
            kernels = [("bsr_spgemm_kernel",
                        bsr_spgemm.launch_smem(target.args[0], target.args[1], bs))]
        else:
            raise ValueError(f"no shared-memory arithmetic for kernel {launch.kernel!r}")
        for name, dynamic in kernels:
            static = _static_smem(build_log, launch.kernel, name)
            out.append({"source": launch.kernel, "kernel": name, "dynamic": dynamic,
                        "static": static, "total": dynamic + (static or 0)})
    return out


def audit_smem(target, launches, model=None, build_log: dict | None = None) -> SmemAudit:
    """Audit one staged core from its recorded ``launches`` against a
    :class:`~repro_torch.core.planner.BackendFastModel` (or None)."""
    pieces = c = work = 0.0
    for launch in launches:
        p, cb, w = step_bytes(launch)
        if p + cb + w > pieces + c + work:
            pieces, c, work = p, cb, w
    return SmemAudit(
        step_bytes=pieces + c + work,
        model_bytes=float(model.fast_bytes_needed) if model is not None else None,
        piece_bytes=pieces, c_bytes=c, workspace_bytes=work,
        requests=tuple(launch_requests(target, launches, build_log)),
        n_launches=len(launches))


def check_smem(audit: SmemAudit) -> list:
    """Violations of one audit: an undercounting model, a request past the
    block's shared memory."""
    out = []
    if audit.dominated is False:
        out.append(
            f"byte model undercounts the staged step: model claims "
            f"{audit.model_bytes:.0f} B but one step stages {audit.step_bytes:.0f} B "
            f"(pieces {audit.piece_bytes:.0f} + C block {audit.c_bytes:.0f} + "
            f"workspace {audit.workspace_bytes:.0f})")
    for r in audit.over_limit:
        out.append(
            f"{r['source']}/{r['kernel']} asks for {r['total']} B of shared memory "
            f"(dynamic {r['dynamic']} + static {r['static']}), more than the "
            f"{SMEM_PER_BLOCK} a block has")
    return out
