"""Fault-tolerant checkpointing: atomic manifests, keep-k, restore anywhere.

The port of the JAX package's ``ckpt/checkpoint.py``. A tree is nested
dicts (string keys) of tensors, e.g. ``{"params":
model.state_dict(), "opt": opt_state}``. Layout:

    <dir>/step_<N>/
        manifest.json      step, and each leaf's name (its "/"-joined
                           path), shape and dtype
        arr_<i>.npy        one file a leaf, in host memory order
    <dir>/step_<N>.tmp/    staging; ``os.replace`` on completion

Properties (tested):
  * atomicity: a partly written checkpoint is never visible (tmp + rename);
    restore reads the newest *complete* step.
  * restore onto any device: leaves are saved from host copies and placed
    on the device asked for (by default each like-leaf's), the one-device
    counterpart of the reference's elastic restore.
  * structure: a tree whose leaves differ from the manifest's (count, names
    or shapes) raises ``ValueError``.
  * preemption: ``CheckpointManager`` installs a SIGTERM handler that flags
    a final save at the next step boundary (``should_save_now``).
  * retention: keep_last_k removes old steps after a successful save.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import signal
import threading

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> list:
    """[(path, leaf)] of a nested dict in its insertion order."""
    if isinstance(tree, dict):
        out = []
        for key, sub in tree.items():
            out.extend(_flatten(sub, f"{prefix}{key}/"))
        return out
    return [(prefix[:-1], tree)]


def _unflatten(like, leaves):
    if isinstance(like, dict):
        return {key: _unflatten(sub, leaves) for key, sub in like.items()}
    return next(leaves)


def save_checkpoint(directory: str, step: int, tree, keep_last_k: int = 3) -> str:
    """Atomically persist a tree. Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": int(step), "leaves": []}
    for i, (name, leaf) in enumerate(_flatten(tree)):
        arr = leaf.detach().cpu().numpy()
        np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
        manifest["leaves"].append({"index": i, "name": name, "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)          # atomic visibility
    _gc(directory, keep_last_k)
    return final


def _gc(directory: str, keep_last_k: int) -> None:
    steps = sorted(_complete_steps(directory))
    for s in steps[:-keep_last_k] if keep_last_k else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


def _complete_steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return [int(name[len("step_"):]) for name in os.listdir(directory)
            if name.startswith("step_") and not name.endswith(".tmp")
            and os.path.exists(os.path.join(directory, name, "manifest.json"))]


def latest_step(directory: str):
    steps = _complete_steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, tree_like, step: int | None = None, device=None):
    """Restore into the structure of ``tree_like`` (its values are not
    read; its tensors' shapes are checked). Each leaf goes to ``device``, or
    to its like-leaf's device. Returns (tree, step)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = _flatten(tree_like)
    if len(flat_like) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, expected "
            f"{len(flat_like)} — structure changed?")
    out = []
    for (name, like), rec in zip(flat_like, manifest["leaves"]):
        if name != rec["name"]:
            raise ValueError(f"leaf {rec['index']}: {rec['name']!r} saved, {name!r} expected "
                             "— structure changed?")
        arr = np.load(os.path.join(path, f"arr_{rec['index']}.npy"))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"leaf {name}: shape {arr.shape} != {tuple(like.shape)}")
        out.append(torch.from_numpy(arr).to(like.device if device is None else device))
    return _unflatten(tree_like, iter(out)), step


class CheckpointManager:
    """Save cadence + preemption handling for the training loop."""

    def __init__(self, directory: str, every_steps: int = 100, keep_last_k: int = 3,
                 install_sigterm: bool = True):
        self.directory = directory
        self.every_steps = every_steps
        self.keep_last_k = keep_last_k
        self._preempted = False
        self._thread = None
        if install_sigterm:
            # ValueError: not on the main thread
            with contextlib.suppress(ValueError):
                signal.signal(signal.SIGTERM, self._on_sigterm)

    def _on_sigterm(self, _signum, _frame):
        self._preempted = True

    @property
    def preempted(self) -> bool:
        return self._preempted

    def should_save_now(self, step: int) -> bool:
        return self._preempted or (step > 0 and step % self.every_steps == 0)

    def save(self, step: int, tree) -> str:
        return save_checkpoint(self.directory, step, tree, self.keep_last_k)

    def save_async(self, step: int, tree) -> None:
        """Snapshot to host memory on the caller's thread, write the files in
        the background (one save in flight at a time)."""
        self.wait()
        host = _unflatten(tree, iter(leaf.detach().to("cpu", copy=True)
                                     for _, leaf in _flatten(tree)))
        self._thread = threading.Thread(
            target=save_checkpoint, args=(self.directory, step, host, self.keep_last_k),
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def restore_or_none(self, tree_like, device=None):
        if latest_step(self.directory) is None:
            return None
        return restore_checkpoint(self.directory, tree_like, device=device)
