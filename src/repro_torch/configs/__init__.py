"""Assigned architecture registry: ``get_config(arch_id, smoke=False)``.

Each module defines ``full()`` (the exact published config) and
``smoke()`` (a reduced same-family config for CPU tests).
"""
from __future__ import annotations

import importlib

ARCHS = {
    "seamless-m4t-medium": "seamless_m4t_medium",
    "mixtral-8x22b": "mixtral_8x22b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "starcoder2-7b": "starcoder2_7b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "chatglm3-6b": "chatglm3_6b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "zamba2-7b": "zamba2_7b",
    "mamba2-780m": "mamba2_780m",
}


def get_config(arch: str, smoke: bool = False):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.smoke() if smoke else mod.full()


def all_archs():
    return list(ARCHS)
