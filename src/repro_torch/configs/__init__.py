"""Architecture config registry: ``get_config("yi-6b")`` etc.

Same names as ``repro.configs``. Only the architectures this port serves
are registered; the others are listed in ROADMAP.md (MoE, VLM and the
recurrent archs wait for their model code).
"""
from __future__ import annotations

import importlib
from typing import List

ARCH_IDS: List[str] = ["yi_6b"]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIAS.update({"tiny": "tiny"})


def canon(arch: str) -> str:
    key = arch.replace(".", "-")
    return _ALIAS.get(key, _ALIAS.get(arch, arch)).replace("-", "_").replace(".", "_")


def get_module(arch: str):
    name = canon(arch)
    if name not in ARCH_IDS and name != "tiny":
        raise NotImplementedError(
            f"architecture {arch!r} is not ported to repro_torch yet "
            f"(ported: tiny, {', '.join(a.replace('_', '-') for a in ARCH_IDS)};"
            f" see ROADMAP.md Queue 1)")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str, smoke: bool = False):
    mod = get_module(arch)
    return mod.SMOKE if smoke else mod.CONFIG
