"""Architecture config registry: ``--arch <id>`` resolution.

The port of the JAX package's ``configs/__init__.py``. Each config module
defines CONFIG (the published configuration) and SMOKE (a reduced
same-family configuration for CPU tests). The dense, MoE, SSM (RWKV-6) and
hybrid (Mamba-2 with a shared attention block) families without a frontend
are ported (``PORTED``); ``get_config`` on another architecture raises and
names ROADMAP.md, where the rest is queued.
"""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "olmoe_1b_7b",
    "mixtral_8x22b",
    "deepseek_67b",
    "llama3_2_1b",
    "minitron_4b",
    "starcoder2_7b",
    "llava_next_mistral_7b",
    "musicgen_medium",
    "rwkv6_3b",
    "zamba2_1p2b",
)

# accept dashed spellings from the assignment table
ALIASES = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "deepseek-67b": "deepseek_67b",
    "llama3.2-1b": "llama3_2_1b",
    "minitron-4b": "minitron_4b",
    "starcoder2-7b": "starcoder2_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "musicgen-medium": "musicgen_medium",
    "rwkv6-3b": "rwkv6_3b",
    "zamba2-1.2b": "zamba2_1p2b",
}

PORTED = ("deepseek_67b", "llama3_2_1b", "minitron_4b", "olmoe_1b_7b", "rwkv6_3b",
          "starcoder2_7b", "zamba2_1p2b")
# the ROADMAP.md Queue 1 item that ports each unported arch
_QUEUED = {"mixtral_8x22b": "8"}


def canonical(name: str) -> str:
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return name


def get_config(name: str, smoke: bool = False):
    arch = canonical(name)
    if arch not in PORTED:
        raise ValueError(f"arch {arch!r} is not ported to repro_torch yet "
                         f"(ported: {PORTED}); see ROADMAP.md Queue 1 item "
                         f"{_QUEUED.get(arch, '9')}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG
