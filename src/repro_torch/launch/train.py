"""Training launcher: a real training run on one card (or on the CPU).

The port of the JAX package's ``launch/train.py``. One card holds the model
and its optimizer state whole, so there is no mesh: ``--model-parallel``
above 1 raises (``parallel/`` is queued in ROADMAP.md Queue 1 item 9e).
Every family trains: dense, MoE, SSM (RWKV-6) and hybrid (Zamba2).

Fault-tolerance wiring:
  * CheckpointManager: periodic + SIGTERM-triggered saves, keep-k.
  * resume: restores the parameters, the optimizer state and the step, and
    fast-forwards the data iterator (the pipeline is indexable by step, so
    resume replays the same stream).
  * straggler watchdog: a per-step wall-time EWMA; steps slower than
    ``straggler_factor`` x the EWMA are counted and logged with their index.

    python -m repro_torch.launch.train --arch llama3_2_1b --steps 8
    python -m repro_torch.launch.train --arch llama3_2_1b --smoke --device cpu
    python -m repro_torch.launch.train --arch zamba2_1p2b --smoke --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_batch_iterator
from repro_torch.models import transformer as tf
from repro_torch.models.layers import pdtype
from repro_torch.sparse.csr import resolve_device
from repro_torch.train.optim import TrainConfig
from repro_torch.train.step import init_opt_state, make_train_step


@dataclasses.dataclass
class RunStats:
    steps: int = 0
    last_loss: float = float("nan")
    stragglers: int = 0
    resumed_from: int | None = None
    # one record a step run: step, loss, grad_norm, lr, moe_aux, ms (the
    # step's wall, up to its loss on the host)
    history: list = dataclasses.field(default_factory=list, repr=False)


def train_loop(cfg, tcfg: TrainConfig, *, device=None, batch_size: int = 8,
               seq_len: int = 128, steps: int = 50, ckpt_dir: str | None = None,
               ckpt_every: int = 20, straggler_factor: float = 3.0, log_every: int = 10,
               seed: int = 0, weight_seed: int | None = None, _step_hook=None) -> RunStats:
    """Train ``cfg`` from f32 masters drawn from ``weight_seed`` (default
    ``seed``) on ``SyntheticLM`` batches of ``seed``, on the card unless
    ``device`` says otherwise, up to step ``steps``.

    ``_step_hook(step)`` is a test seam: called inside the timed region of
    every step (used to inject artificial stragglers)."""
    device = resolve_device(device)
    tf.check_ported(cfg)
    tf.check_levers(cfg)
    stats = RunStats()
    gen = torch.Generator(device=device).manual_seed(seed if weight_seed is None
                                                     else weight_seed)
    params = tf.init_params(cfg, gen, device, dtype=pdtype(cfg))
    opt_state = init_opt_state(cfg, tcfg, params)

    start_step = 0
    mgr = CheckpointManager(ckpt_dir, every_steps=ckpt_every) if ckpt_dir else None
    if mgr is not None:
        restored = mgr.restore_or_none({"params": params.state_dict(), "opt": opt_state})
        if restored is not None:
            state, start_step = restored
            params.load_state_dict(state["params"])
            opt_state = state["opt"]
            stats.resumed_from = start_step
            print(f"[train] resumed from step {start_step}")

    it = make_batch_iterator(cfg, batch_size, seq_len, seed, start_index=start_step,
                             device=device)
    step_fn = make_train_step(cfg, tcfg)

    ewma = None
    for step in range(start_step, steps):
        _, batch = next(it)
        t0 = time.perf_counter()
        if _step_hook is not None:
            _step_hook(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])   # waits for the step
        dt = time.perf_counter() - t0
        # the first steps carry the allocator's and the libraries' warm-up;
        # the watchdog arms after two
        if step - start_step >= 2:
            if ewma is not None and dt > straggler_factor * ewma:
                stats.stragglers += 1
                print(f"[train] straggler: step {step} took {dt:.2f}s (ewma {ewma:.2f}s)")
            else:
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        gnorm, lr = float(metrics["grad_norm"]), float(metrics["lr"])
        stats.history.append({"step": step, "loss": loss, "grad_norm": gnorm, "lr": lr,
                              "moe_aux": float(metrics["moe_aux"]), "ms": dt * 1e3})
        if step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"lr {lr:.2e} {dt*1e3:.0f}ms")
        stats.steps = step + 1
        stats.last_loss = loss
        if mgr is not None and mgr.should_save_now(step + 1):
            mgr.save(step + 1, {"params": params.state_dict(), "opt": opt_state})
            if mgr.preempted:
                print("[train] preempted; checkpoint saved, exiting")
                break
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", choices=("none", "int8"), default="none")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel above 1 needs parallel/ (a mesh and sharding rules), "
            "which is not ported to repro_torch; see ROADMAP.md Queue 1 item 9e")

    cfg = get_config(args.arch, smoke=args.smoke)
    tcfg = TrainConfig(learning_rate=args.lr, microbatches=args.microbatches,
                       grad_compression=args.grad_compression,
                       total_steps=args.steps, warmup_steps=max(args.steps // 10, 1))
    stats = train_loop(cfg, tcfg, device=args.device, batch_size=args.batch_size,
                       seq_len=args.seq_len, steps=args.steps, ckpt_dir=args.ckpt_dir,
                       seed=args.seed)
    print(f"[train] done: {stats}")


if __name__ == "__main__":
    main()
