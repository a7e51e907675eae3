"""The port's data pipeline, checkpoints and training loop.

* ``SyntheticLM``: batches equal to the reference's value for value for
  several ``(seed, index)`` and shapes (a frontend config raises);
  ``make_batch_iterator`` yields them as tensors from ``start_index``.
* Checkpoints: a round trip of nested tensors (f32, f64, int32, int64, a
  0-dim step) restored onto a named device; a model's ``state_dict`` and its
  optimizer state into a fresh model; a crashed ``.tmp`` and a directory
  without a manifest stay invisible; keep-last-k; a structure mismatch
  (leaf count, names, shapes) raises; the manager's cadence, its SIGTERM
  flag and its async save.
* ``train_loop``: resume is bit for bit on the CPU (6 steps straight
  against 3, a checkpoint, then 3 more, microbatches 2 with int8: every
  loss and every tensor of the step-6 checkpoints equal); an injected slow
  step is flagged by the straggler watchdog (``_step_hook``); the loss
  falls on the llama SMOKE config; ``device=None`` raises without a card;
  the CLI refuses ``--model-parallel`` above 1; ``examples/torch_train_lm.py``
  runs at a small size.
"""

import dataclasses
import importlib.util
import os
import signal
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import pipeline as ref_pipeline
from repro_torch import configs
from repro_torch.ckpt import checkpoint as ck
from repro_torch.data.pipeline import SyntheticLM, make_batch_iterator
from repro_torch.launch import train
from repro_torch.models import transformer as tf
from repro_torch.models.layers import pdtype
from repro_torch.train.optim import TrainConfig
from repro_torch.train.step import init_opt_state
from test_torch_train_forward import one_torch_thread  # noqa: F401 (a fixture)

CFG = configs.get_config("llama3_2_1b", smoke=True)
ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,index", [(0, 0), (0, 5), (7, 3), (123, 40)])
@pytest.mark.parametrize("batch,seq", [(4, 32), (3, 17)])
def test_synthetic_batches_equal_reference(seed, index, batch, seq):
    got = SyntheticLM(CFG, batch, seq, seed=seed).batch(index)
    want = ref_pipeline.SyntheticLM(ref_configs.get_config("llama3_2_1b", smoke=True),
                                    batch, seq, seed=seed).batch(index)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_synthetic_refuses_frontend_configs():
    with pytest.raises(NotImplementedError, match="frontend"):
        SyntheticLM(dataclasses.replace(CFG, frontend="vision_stub"), 4, 32)


def test_batch_iterator_starts_at_its_index():
    it = make_batch_iterator(CFG, 2, 16, seed=3, start_index=5, device="cpu")
    for want_i in (5, 6):
        i, batch = next(it)
        assert i == want_i
        host = SyntheticLM(CFG, 2, 16, seed=3).batch(i)
        for k, v in batch.items():
            assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(), host[k])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 8, generator=g),
                       "h": torch.randn(3, 5, generator=g).to(torch.float64)},
            "opt": {"mu": torch.zeros(8, 8), "step": torch.tensor(7, dtype=torch.int32),
                    "count": torch.arange(6)}}


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_checkpoint_roundtrip_onto_a_device(tmp_path):
    t = _tree()
    ck.save_checkpoint(str(tmp_path), 10, t)
    restored, step = ck.restore_checkpoint(str(tmp_path), t, device="cpu")
    assert step == 10
    _assert_trees_equal(restored, t)
    assert restored["opt"]["step"].shape == ()


def test_model_and_optimizer_state_restore_into_a_fresh_model(tmp_path):
    model = tf.init_params(CFG, torch.Generator().manual_seed(1), device="cpu",
                           dtype=pdtype(CFG))
    tcfg = TrainConfig(grad_compression="int8")
    opt = init_opt_state(CFG, tcfg, model)
    with torch.no_grad():
        for v in opt["mu"].values():
            v.normal_()
    ck.save_checkpoint(str(tmp_path), 3, {"params": model.state_dict(), "opt": opt})
    fresh = tf.init_params(CFG, torch.Generator().manual_seed(2), device="cpu",
                           dtype=pdtype(CFG))
    state, step = ck.restore_checkpoint(
        str(tmp_path), {"params": fresh.state_dict(), "opt": init_opt_state(CFG, tcfg, fresh)})
    fresh.load_state_dict(state["params"])
    assert step == 3
    _assert_trees_equal(fresh.state_dict(), model.state_dict())
    _assert_trees_equal(state["opt"], opt)


def test_atomicity_partial_write_invisible(tmp_path):
    t = _tree()
    ck.save_checkpoint(str(tmp_path), 10, t)
    crash = tmp_path / "step_00000020.tmp"     # a crashed half-finished save
    crash.mkdir()
    (crash / "arr_0.npy").write_bytes(b"garbage")
    assert ck.latest_step(str(tmp_path)) == 10
    _, step = ck.restore_checkpoint(str(tmp_path), t)
    assert step == 10
    (tmp_path / "step_00000030").mkdir()       # no manifest: incomplete
    assert ck.latest_step(str(tmp_path)) == 10


def test_keep_last_k(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ck.save_checkpoint(str(tmp_path), s, t, keep_last_k=2)
    steps = sorted(int(n[5:]) for n in os.listdir(tmp_path)
                   if n.startswith("step_") and not n.endswith(".tmp"))
    assert steps == [4, 5]


def test_structure_mismatch_rejected(tmp_path):
    ck.save_checkpoint(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        ck.restore_checkpoint(str(tmp_path), {"only": torch.zeros(3)})
    renamed = _tree()
    renamed["params"]["v"] = renamed["params"].pop("w")
    with pytest.raises(ValueError, match="structure changed"):
        ck.restore_checkpoint(str(tmp_path), renamed)
    reshaped = _tree()
    reshaped["params"]["w"] = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="shape"):
        ck.restore_checkpoint(str(tmp_path), reshaped)
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(str(tmp_path / "none"), _tree())


def test_manager_cadence_preemption_and_sigterm(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), every_steps=10, install_sigterm=False)
    assert not mgr.should_save_now(0) and not mgr.should_save_now(5)
    assert mgr.should_save_now(10) and mgr.should_save_now(20)
    mgr._preempted = True
    assert mgr.should_save_now(1)   # preemption forces a save
    previous = signal.getsignal(signal.SIGTERM)
    try:
        mgr = ck.CheckpointManager(str(tmp_path), every_steps=10)
        assert not mgr.preempted
        # the manager's handler must be in place before the signal is sent
        assert signal.getsignal(signal.SIGTERM) == mgr._on_sigterm
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):        # the handler runs at the next bytecode
            if mgr.preempted:
                break
            time.sleep(0.01)
        assert mgr.preempted and mgr.should_save_now(3)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert mgr.restore_or_none(_tree()) is None


def test_async_save_roundtrip(tmp_path):
    t = _tree(seed=3)
    mgr = ck.CheckpointManager(str(tmp_path), every_steps=1, install_sigterm=False)
    mgr.save_async(11, t)
    mgr.save_async(12, t)   # waits for the first
    mgr.wait()
    restored, step = mgr.restore_or_none(t)
    assert step == 12
    _assert_trees_equal(restored["params"], t["params"])


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------


def _checkpoint_arrays(directory, step):
    path = Path(directory) / f"step_{step:08d}"
    n = len(list(path.glob("arr_*.npy")))
    return [np.load(path / f"arr_{i}.npy") for i in range(n)]


def test_resume_is_bit_for_bit(tmp_path):
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=6, warmup_steps=1, microbatches=2,
                       grad_compression="int8")
    kw = dict(device="cpu", batch_size=4, seq_len=16, ckpt_every=3, log_every=100)
    straight = train.train_loop(CFG, tcfg, steps=6, ckpt_dir=str(tmp_path / "a"), **kw)
    first = train.train_loop(CFG, tcfg, steps=3, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = train.train_loop(CFG, tcfg, steps=6, ckpt_dir=str(tmp_path / "b"), **kw)
    assert first.resumed_from is None and resumed.resumed_from == 3
    assert [h["loss"] for h in first.history + resumed.history] == \
        [h["loss"] for h in straight.history]
    assert resumed.last_loss == straight.last_loss
    a, b = _checkpoint_arrays(tmp_path / "a", 6), _checkpoint_arrays(tmp_path / "b", 6)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_straggler_watchdog_detects_slow_steps():
    tcfg = TrainConfig(total_steps=12, warmup_steps=1)

    calls = []

    def hook(step):
        calls.append(time.perf_counter())
        if step == 8:   # ten times the longest step so far (a loaded host's too)
            longest = max(b - a for a, b in zip(calls, calls[1:]))
            time.sleep(max(1.0, 10 * longest))

    stats = train.train_loop(CFG, tcfg, device="cpu", batch_size=2, seq_len=16, steps=12,
                             log_every=100, straggler_factor=3.0, _step_hook=hook)
    assert stats.stragglers >= 1 and stats.steps == 12


def test_loss_falls_on_smoke():
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=30, warmup_steps=2)
    stats = train.train_loop(CFG, tcfg, device="cpu", batch_size=4, seq_len=32, steps=15,
                             log_every=100)
    losses = [h["loss"] for h in stats.history]
    assert len(losses) == 15 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.2, losses
    assert [h["step"] for h in stats.history] == list(range(15))


def test_train_loop_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train_loop(CFG, TrainConfig(), steps=1)


def test_cli(capsys):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.main(["--arch", "llama3_2_1b", "--smoke", "--model-parallel", "2"])
    train.main(["--arch", "llama3_2_1b", "--smoke", "--device", "cpu", "--steps", "2",
                "--batch-size", "2", "--seq-len", "16"])
    assert "[train] done" in capsys.readouterr().out


def test_example_trains(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    stats = example.main(["--device", "cpu", "--steps", "3", "--d-model", "64", "--layers",
                          "1", "--seq-len", "32", "--batch-size", "4",
                          "--ckpt-dir", str(tmp_path)])
    assert stats.steps == 3 and np.isfinite(stats.last_loss)
    assert "[train_lm] finished" in capsys.readouterr().out
