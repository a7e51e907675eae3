"""The serving and training launchers on the SSM and hybrid families:
``python -m repro_torch.launch.serve`` and ``python -m
repro_torch.launch.train`` with ``--arch zamba2_1p2b`` and ``--arch
rwkv6_3b``, ``--smoke --device cpu``, run as ``python -m`` runs them
(``runpy.run_module`` as ``__main__``, with that command line): every
request served its tokens, and every training step's loss printed finite. And ``train_loop`` of both
SMOKE configs resumed from a checkpoint equals the straight run bit for
bit (losses and every step-4 leaf); the hybrid's checkpoint holds the
shared block's weights once."""

import json
import re
import runpy
import sys
from unittest import mock

import numpy as np
import pytest

from repro_torch import configs
from repro_torch.launch import train
from repro_torch.train.optim import TrainConfig
from test_torch_train_forward import one_torch_thread  # noqa: F401 (a fixture)


def _run(capsys, module: str, *args: str) -> str:
    """``python -m module args...``'s output."""
    capsys.readouterr()
    with mock.patch.object(sys, "argv", [module, *args]):
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    return capsys.readouterr().out


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "rwkv6_3b"])
def test_serve_cli(arch, capsys):
    out = _run(capsys, "repro_torch.launch.serve", "--arch", arch, "--smoke", "--device", "cpu",
               "--batch", "2", "--prompt-len", "9", "--max-new-tokens", "3",
               "--cache-len", "16")
    assert len(re.findall(r"\[serve\] seq \d: 3 tokens", out)) == 2, out
    assert "tok/s decode" in out


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "rwkv6_3b"])
def test_train_cli(arch, capsys):
    out = _run(capsys, "repro_torch.launch.train", "--arch", arch, "--smoke", "--device", "cpu",
               "--steps", "2", "--batch-size", "2", "--seq-len", "16")
    losses = [float(x) for x in re.findall(r"\[train\] step +\d+ loss (\S+)", out)]
    assert len(losses) == 1 and all(x == x and abs(x) < 100 for x in losses), out
    assert "[train] done: RunStats(steps=2" in out, out


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "rwkv6_3b"])
def test_resume_is_bit_for_bit(arch, tmp_path):
    cfg = configs.get_config(arch, smoke=True)
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=4, warmup_steps=1)
    kw = dict(device="cpu", batch_size=2, seq_len=16, ckpt_every=2, log_every=100)
    straight = train.train_loop(cfg, tcfg, steps=4, ckpt_dir=str(tmp_path / "a"), **kw)
    train.train_loop(cfg, tcfg, steps=2, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = train.train_loop(cfg, tcfg, steps=4, ckpt_dir=str(tmp_path / "b"), **kw)
    assert resumed.resumed_from == 2
    assert [h["loss"] for h in resumed.history] == [h["loss"] for h in straight.history[2:]]
    step = "step_00000004"
    names = [leaf["name"] for leaf in json.loads(
        (tmp_path / "a" / step / "manifest.json").read_text())["leaves"]]
    shared = [n for n in names if n.startswith("params/shared_attn.")]
    assert len(shared) == (9 if arch == "zamba2_1p2b" else 0) == len(set(shared))
    for i in range(len(names)):
        np.testing.assert_array_equal(np.load(tmp_path / "a" / step / f"arr_{i}.npy"),
                                      np.load(tmp_path / "b" / step / f"arr_{i}.npy"))
