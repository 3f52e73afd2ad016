"""Guards on the port's sources, checked on the CPU: what the port may
import and call, how its kernels are built and dispatched, and that its
entry points default to the CUDA device.
"""
import ast
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _tree(path):
    return ast.parse(path.read_text(), filename=str(path))


def _imported_modules(path):
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
            f"{path.name} imports {mod}"


FORBIDDEN = ("scaled_dot_product_attention", "torch.compile", "flash_attn",
             "xformers", "cudnn", "_scaled_dot_product")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_attention_or_compile_on_the_port_paths(path):
    text = path.read_text()
    if path.name == "chip_smoke.py":
        # the smoke script times ONE library call as a yardstick
        # (library_ms); it must live in a function named for that alone
        text = re.sub(r"def library_[a-z_]+\(.*?\n(?=def |\Z)", "", text,
                      flags=re.S)
    for word in FORBIDDEN:
        assert word not in text, f"{path.name} mentions {word}"


def test_no_fallback_around_kernel_launches():
    for path in sorted((PKG / "kernels").glob("*.py")):
        for node in ast.walk(_tree(path)):
            assert not isinstance(node, ast.Try), \
                f"{path.name}:{node.lineno} has a try around kernel code"


def test_every_kernel_has_a_cuda_source_named_by_the_build():
    from repro_torch.kernels import _build
    assert set(_build.SOURCES) == {"flash_attention", "chunk_attention"}
    launchers = {fn for fns in _build.LAUNCHERS.values() for fn in fns}
    assert launchers == {"aios_flash_attention", "aios_chunk_attention",
                         "aios_packed_chunk_attention"}
    for name, src in _build.SOURCES.items():
        text = (_build.CSRC / src).read_text()
        for fn in _build.LAUNCHERS[name]:
            assert f'extern "C" int {fn}(' in text
    for header in _build.HEADERS:
        assert (_build.CSRC / header).exists()
    assert "compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_non_cpu_tensors_never_take_the_plain_path():
    """A tensor that is not on the CPU goes to the CUDA kernel wrapper,
    which refuses what is not a CUDA tensor -- nothing falls back."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    q = torch.empty((1, 4, 2, 16), device="meta")
    k = torch.empty((1, 8, 2, 16), device="meta")
    i32 = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        ops.chunk_attention(q, k, k, i32, i32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.packed_chunk_attention(q[0], k, k, i32, i32, i32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q[:, 0], k, k, i32)
    assert ops.launch_counts() == before       # a refused launch never counts


def test_entry_points_default_to_the_card(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core.kernel import AIOSKernel
    from repro_torch.serving.engine import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(get_config("tiny"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AIOSKernel(arch="tiny")
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_options_are_refused_not_imitated():
    from repro_torch.configs import get_config
    from repro_torch.core.kernel import AIOSKernel
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine
    for kw in ({"paged_kv": True}, {"control": True}, {"trace": True},
               {"record": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            AIOSKernel(arch="tiny", device="cpu", **kw)
    for kw in ({"prefix_cache": object()}, {"page_store": object()},
               {"tracer": object()}, {"spec_decode": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine(get_config("tiny"), device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("rwkv6-1.6b")
    cfg = get_config("yi-6b").replace(family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg)


def test_non_llm_syscalls_fail_naming_the_missing_manager():
    from repro_torch.core.kernel import AIOSKernel
    from repro_torch.sdk.query import (AccessQuery, MemoryQuery, StorageQuery,
                                       ToolQuery)
    with AIOSKernel(arch="tiny", device="cpu",
                    engine_kw={"max_slots": 2, "max_len": 64}) as k:
        for q, manager in ((MemoryQuery("add_memory"), "memory manager"),
                           (StorageQuery("sto_write"), "storage manager"),
                           (ToolQuery("calculator"), "tool manager"),
                           (AccessQuery("check_access"), "access manager")):
            sc = k.submit(q.to_syscall("agent"))
            with pytest.raises(RuntimeError, match=manager):
                sc.join(timeout=5)
