"""PyTorch/CUDA port of the AIOS reproduction package (``repro``).

Module for module, ``repro_torch.<sub>.<mod>`` mirrors ``repro.<sub>.<mod>``:
plain tensor code is PyTorch, and every attention kernel the serving path
runs is a hand-written CUDA C++ kernel for Hopper (``csrc/``, built with
``nvcc`` at first use by ``kernels/_build.py``). The package never imports
``jax`` or ``repro``; only the parity tests import both.

Entry points (``AIOSKernel``, ``ServingEngine``) run on the CUDA device
unless the caller passes ``device="cpu"``, and raise when asked for nothing
on a machine without a GPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Without a GPU an unnamed device is an error -- the port never
    carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
