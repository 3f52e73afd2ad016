#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. device   -- the card's name and power limit; build the CUDA kernels
                 from ``src/repro_torch/csrc`` with nvcc (timed).
  2. kernels  -- each kernel against its plain PyTorch version on the card,
                 at yi-6b shapes, in bf16 and fp32 (stated tolerances), with
                 CUDA-event times of the kernel, the plain version and one
                 library call that computes the same function (a yardstick
                 the port never calls), and each kernel's bound.
  3. batched  -- ``AIOSKernel(arch="yi-6b", scheduler="batched")`` serves 8
                 greedy requests (prompts 64..512, 32 new tokens each) with
                 random weights; the chunk and packed kernels must launch.
  4. rr       -- the same model under ``scheduler="rr", quantum=16``: two
                 40-token requests are suspended and restored; the flash
                 kernel must launch, and the tokens must equal one
                 uninterrupted engine's.
  5. logits   -- prefill logits with the kernels against the same prefill
                 with the plain attention, on the card.

Then the kernels line, the card's ``nvidia-smi`` name and power limit, and
as the last line ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the repository beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
PEAK_BYTES = 3.35e12                    # H100 SXM HBM3, bytes/s
PEAK_OPS = {torch.bfloat16: 989e12,     # dense bf16 tensor-core FLOP/s
            torch.float32: 67e12}       # fp32 outside the tensor cores
# fp32: an absolute bound (summation order only). bf16: kernel and plain
# version each round an fp32 result to bf16, so they may differ by one bf16
# ulp of the output: 2**-7 of the largest |output| (plus fp32 noise).
FP32_TOL = 1e-4
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:120",
    "chunk_attention": "src/repro/kernels/decode_attention.py:128",
    "packed_chunk_attention": "src/repro/kernels/decode_attention.py:272",
}
SOURCE = {"flash_attention": "src/repro_torch/csrc/flash_attention.cu",
          "chunk_attention": "src/repro_torch/csrc/chunk_attention.cu",
          "packed_chunk_attention": "src/repro_torch/csrc/chunk_attention.cu"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_attention(q, k, v, mask):
    """The yardstick: one PyTorch call computing the same attention.
    q [B, H, Sq, hd]; k, v already expanded to H heads; mask [B, 1, Sq, S]."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _bound(bytes_moved: float, flops: float, dtype):
    t_bytes = bytes_moved / PEAK_BYTES
    t_ops = flops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _pairs_and_kv_rows(qpos, live, S, window, kv_lens=None):
    """Valid (query, key) pairs per query and the K/V rows each batch row
    needs, for this run's data. qpos, live: [B, Q] (positions, liveness)."""
    kpos = torch.arange(S, device=qpos.device)
    m = (kpos[None, None, :] <= qpos[..., None]) & live[..., None]
    if kv_lens is not None:
        m &= kpos[None, None, :] < kv_lens[:, None, None]
    if window:
        m &= kpos[None, None, :] > (qpos[..., None] - window)
    pairs = int(m.sum())
    rows = int(m.any(dim=1).sum())          # distinct keys read per batch row
    return pairs, rows


def compare(got, ref, sel=None):
    """(max abs error, tolerance) of a kernel's output against its plain
    version's on the selected rows (``sel`` a boolean mask over the leading
    axes; default all)."""
    d = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    if sel is not None:
        d, r = d[sel], r[sel]
    if ref.dtype == torch.float32:
        return d.max().item(), FP32_TOL
    return d.max().item(), 2.0 ** -7 * r.max().item() + 1e-5


def _report(name, dtype, err_tol, ms, plain_ms, lib_ms, bytes_moved, flops,
            extra):
    err, tol = err_tol
    bound_ms, bound_by = _bound(bytes_moved, flops, dtype)
    row = {"phase": "kernel", "name": name, "dtype": str(dtype).split(".")[1],
           "max_abs_err": err, "tol": tol, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, **extra}
    emit(row)
    check(err <= tol, f"{name} {dtype}: max abs err {err} > {tol}")
    return row


def kernel_checks(ops, cfg, dev):
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    for dtype in (torch.bfloat16, torch.float32):
        es = torch.tensor([], dtype=dtype).element_size()
        # -- flash: prefill, B=2, Sq=Skv=512, unequal offsets / kv lengths
        for window in (0, 256):
            B, S = 2, 512
            q, k, v = rnd(B, S, H, hd, dtype=dtype), rnd(B, S, K, hd, dtype=dtype), \
                rnd(B, S, K, hd, dtype=dtype)
            offs, klens = i32([0, 37]), i32([512, 401])
            run = functools.partial(ops.flash_attention, q, k, v, window=window,
                                    q_offsets=offs, kv_lens=klens)
            got = run()
            ref = run(backend="torch")
            qpos = offs.long()[:, None] + torch.arange(S, device=dev)[None]
            # a row whose window lies wholly past kv_len sees no key: the
            # kernel writes zeros there, the plain version a meaningless mean
            has_key = torch.minimum(qpos, klens.long()[:, None] - 1) > (
                qpos - window if window else torch.full_like(qpos, -1))
            err = compare(got, ref, has_key)
            live = torch.ones_like(qpos, dtype=torch.bool)
            pairs, rows = _pairs_and_kv_rows(qpos, live, S, window, klens.long())
            kx = k.repeat_interleave(H // K, dim=2).transpose(1, 2)
            vx = v.repeat_interleave(H // K, dim=2).transpose(1, 2)
            kp = torch.arange(S, device=dev)
            mask = (kp[None, None, :] <= qpos[:, :, None]) & \
                (kp[None, None, :] < klens.long()[:, None, None])
            if window:
                mask &= kp[None, None, :] > qpos[:, :, None] - window
            mask = mask[:, None]
            qt = q.transpose(1, 2)
            results[("flash_attention", dtype, window)] = _report(
                "flash_attention", dtype, err, cuda_ms(run),
                cuda_ms(lambda: run(backend="torch")),
                cuda_ms(lambda: library_attention(qt, kx, vx, mask)),
                (q.numel() + got.numel()) * es + 2 * rows * K * hd * es,
                4.0 * pairs * H * hd,
                {"window": window, "shape": [B, S, H, K, hd]})

        # -- chunk: B=8, C=64, S=1024, q_lens mixing C, 1 and 0
        B, C, S = 8, 64, 1024
        qlens = i32([64, 1, 0, 64, 1, 1, 0, 37])
        offs = i32([0, 900, 5, 300, 1022, 17, 0, 700])
        q = rnd(B, C, H, hd, dtype=dtype)
        kc, vc = rnd(B, S, K, hd, dtype=dtype), rnd(B, S, K, hd, dtype=dtype)
        run = functools.partial(ops.chunk_attention, q, kc, vc, offs, qlens)
        got = run()
        ref = run(backend="torch")
        live = torch.arange(C, device=dev)[None] < qlens.long()[:, None]
        err = compare(got, ref, live)
        check(not got[~live].any(), "chunk_attention: dead rows are not zeros")
        qpos = offs.long()[:, None] + torch.arange(C, device=dev)[None]
        pairs, rows = _pairs_and_kv_rows(qpos, live, S, 0)
        kp = torch.arange(S, device=dev)
        mask = (kp[None, None, :] <= qpos[:, :, None])[:, None]
        kx = kc.repeat_interleave(H // K, dim=2).transpose(1, 2)
        vx = vc.repeat_interleave(H // K, dim=2).transpose(1, 2)
        qt = q.transpose(1, 2)
        results[("chunk_attention", dtype)] = _report(
            "chunk_attention", dtype, err, cuda_ms(run),
            cuda_ms(lambda: run(backend="torch")),
            cuda_ms(lambda: library_attention(qt, kx, vx, mask)),
            (int(live.sum()) * H * hd + got.numel()) * es
            + 2 * rows * K * hd * es, 4.0 * pairs * H * hd,
            {"shape": [B, C, S, H, K, hd], "q_lens": qlens.tolist()})

        # -- decode: B=8, S=1024 (the C == 1 case of the chunk kernel)
        seq = i32([1024, 1, 77, 512, 999, 3, 640, 250])
        qd = rnd(B, H, hd, dtype=dtype)
        run = functools.partial(ops.decode_attention, qd, kc, vc, seq)
        got = run()
        err = compare(got, run(backend="torch"))
        qpos = seq.long()[:, None] - 1
        pairs, rows = _pairs_and_kv_rows(qpos, torch.ones_like(qpos, dtype=torch.bool),
                                         S, 0)
        mask = (kp[None, None, :] <= qpos[:, :, None])[:, None]
        qdt = qd[:, :, None]
        results[("decode_attention", dtype)] = _report(
            "decode_attention", dtype, err, cuda_ms(run),
            cuda_ms(lambda: run(backend="torch")),
            cuda_ms(lambda: library_attention(qdt, kx, vx, mask)),
            (qd.numel() + got.numel()) * es + 2 * rows * K * hd * es,
            4.0 * pairs * H * hd, {"shape": [B, S, H, K, hd]})

        # -- packed: rows [37, 1, 0, 64, 1, 5] at alignment 1 (no gaps)
        plens = np.array([37, 1, 0, 64, 1, 5], np.int32)
        starts = np.concatenate([[0], np.cumsum(plens)[:-1]]).astype(np.int32)
        Np = 128                                     # the packed bucket
        Bp = len(plens)
        poffs = i32([3, 1000, 0, 600, 44, 1018])
        qp = rnd(Np, H, hd, dtype=dtype)
        kc6, vc6 = kc[:Bp], vc[:Bp]
        run = functools.partial(ops.packed_chunk_attention, qp, kc6, vc6,
                                i32(starts), poffs, i32(plens))
        got = run()
        ref = run(backend="torch")
        livep = np.zeros(Np, bool)
        for b in range(Bp):
            livep[starts[b]:starts[b] + plens[b]] = True
        livep = torch.as_tensor(livep, device=dev)
        err = compare(got, ref, livep)
        check(not got[~livep].any(), "packed_chunk_attention: gaps are not zeros")
        Cmax = int(plens.max())
        qpos = poffs.long()[:, None] + torch.arange(Cmax, device=dev)[None]
        live = torch.arange(Cmax, device=dev)[None] < torch.as_tensor(
            plens, device=dev).long()[:, None]
        pairs, rows = _pairs_and_kv_rows(qpos, live, S, 0)
        # the yardstick attends over every row's cache laid end to end, a
        # packed query seeing only its own row's keys up to its position
        pidx = torch.arange(Np, device=dev)
        prow = torch.searchsorted(i32(starts).long(), pidx, right=True) - 1
        ppos = poffs.long()[prow] + pidx - i32(starts).long()[prow]
        key = torch.arange(Bp * S, device=dev)
        pmask = ((key[None] // S == prow[:, None]) &
                 (key[None] % S <= ppos[:, None]) & livep[:, None])[None, None]
        kxp = kc6.repeat_interleave(H // K, dim=2).reshape(Bp * S, H, hd) \
            .transpose(0, 1)[None]
        vxp = vc6.repeat_interleave(H // K, dim=2).reshape(Bp * S, H, hd) \
            .transpose(0, 1)[None]
        qpt = qp.transpose(0, 1)[None]
        results[("packed_chunk_attention", dtype)] = _report(
            "packed_chunk_attention", dtype, err, cuda_ms(run),
            cuda_ms(lambda: run(backend="torch")),
            cuda_ms(lambda: library_attention(qpt, kxp, vxp, pmask)),
            (int(livep.sum()) * H * hd + got.numel()) * es
            + 2 * rows * K * hd * es, 4.0 * pairs * H * hd,
            {"shape": [Np, Bp, S, H, K, hd], "q_lens": plens.tolist()})
    return results


# ---------------------------------------------------------------------------
# phases 3-5: the main path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_attention(ops):
    """Route the model's attention through the plain versions on the card
    (``backend="torch"``) -- for the logits comparison only."""
    names = ("flash_attention", "chunk_attention", "packed_chunk_attention",
             "decode_attention")
    saved = {n: getattr(ops, n) for n in names}
    for n in names:
        setattr(ops, n, functools.partial(saved[n], backend="torch"))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(ops, n, f)


def serve(kernel, LLMQuery, prompts, max_new):
    t0 = time.perf_counter()
    with kernel as k:
        scs = [k.submit(LLMQuery(prompt=p, max_new_tokens=max_new)
                        .to_syscall(f"agent{i}")) for i, p in enumerate(prompts)]
        out = [sc.join(timeout=600)["tokens"] for sc in scs]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_batched(cfg, params, dev, ekw, rng):
    """Phase 3: 8 greedy requests through the batched scheduler."""
    from repro_torch.core.kernel import AIOSKernel
    from repro_torch.kernels import ops
    from repro_torch.sdk.query import LLMQuery
    lens = np.linspace(64, 512, 8).astype(int)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in lens]
    kernel = AIOSKernel(arch=cfg, scheduler="batched", engine_kw=ekw,
                        shared_params=params, device=dev)
    ops.reset_launch_counts()
    out, wall = serve(kernel, LLMQuery, prompts, 32)
    counts = ops.launch_counts()
    stats = kernel.metrics()["engine"][0]
    emit({"phase": "batched", "requests": len(prompts),
          "prompt_lens": lens.tolist(), "wall_s": wall,
          "tokens_per_s": sum(map(len, out)) / wall,
          "packed_dispatches": stats["packed_dispatches"],
          "mixed_steps": stats["mixed_steps"],
          "model_dispatches": stats["model_dispatches"],
          "launches": counts, "profiler": kernel.profiler_summary()[0]})
    check(all(len(t) == 32 for t in out), "batched: a request did not get 32 tokens")
    check(counts["chunk_attention"] > 0, "batched: chunk kernel never launched")
    check(counts["packed_chunk_attention"] > 0,
          "batched: packed kernel never launched")
    return counts


def phase_rr(cfg, params, dev, ekw, rng):
    """Phase 4: two 40-token requests under rr with quantum 16, against one
    uninterrupted engine."""
    from repro_torch.core.kernel import AIOSKernel
    from repro_torch.kernels import ops
    from repro_torch.sdk.query import LLMQuery
    from repro_torch.serving.engine import ServingEngine
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (100, 300)]
    kernel = AIOSKernel(arch=cfg, scheduler="rr", quantum=16, engine_kw=ekw,
                        shared_params=params, device=dev)
    ops.reset_launch_counts()
    out, wall = serve(kernel, LLMQuery, prompts, 40)
    counts = ops.launch_counts()
    stats = kernel.metrics()["engine"][0]
    del kernel
    eng = ServingEngine(cfg, params=params, device=dev, **ekw)
    solo = []
    for p in prompts:
        s = eng.add_sequence(np.asarray(p, np.int32), max_new=40)
        while not eng.is_done(s):
            eng.step()
        solo.append(eng.result(s))
        eng.free(s)
    emit({"phase": "rr", "wall_s": wall, "preemptions": stats["preemptions"],
          "restores": stats["restores"], "launches": counts,
          "tokens_equal_uninterrupted": out == solo})
    check(counts["flash_attention"] > 0, "rr: flash kernel never launched")
    check(stats["preemptions"] >= 1, "rr: no preemption")
    check(all(len(t) == 40 for t in out), "rr: a request did not get 40 tokens")
    check(out == solo, "rr: suspended tokens differ from an uninterrupted run")
    return counts


def phase_logits(cfg, params, dev, rng):
    """Phase 5: prefill logits with the kernels against the plain
    attention on the same device."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    model = build_model(cfg)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, (8, 256)).astype(np.int32),
                           device=dev)
    _, lk = model.prefill(params, toks, model.init_cache(8, 256, dev))
    with plain_attention(ops):
        _, lp = model.prefill(params, toks, model.init_cache(8, 256, dev))
    lk, lp = lk[:, :cfg.vocab].float(), lp[:, :cfg.vocab].float()
    delta = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    ak, ap = lk.argmax(-1), lp.argmax(-1)
    agree = (ak == ap).float().mean().item()
    # where the argmax differs, the plain path's two candidates must lie
    # within the measured delta of each other (a near-tie that bf16
    # rounding may flip), not apart
    rows = torch.arange(len(lp), device=dev)
    gap = (lp[rows, ap] - lp[rows, ak]).max().item()
    finite = bool(torch.isfinite(lk).all())
    emit({"phase": "logits", "prompts": 8, "prompt_len": 256,
          "dtype": str(cfg.dtype).split(".")[1], "max_abs_delta": delta,
          "max_abs_logit": scale, "argmax_agreement": agree,
          "max_flip_gap": gap, "finite": finite})
    check(finite and tuple(lk.shape) == (8, cfg.vocab),
          "logits: not finite or wrong shape")
    check(delta <= 0.05 * scale, f"logits: delta {delta} > 5% of max |logit| {scale}")
    check(gap <= 2 * delta, f"logits: an argmax flip with a plain-path gap "
          f"{gap} > twice the delta {delta}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"run from a checkout of the repository: {ROOT}/src/repro_torch "
             "is missing")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    ops.ensure_built()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0,
          "nvcc_s": _build.build_seconds})

    cfg = get_config("yi-6b")
    kres = kernel_checks(ops, cfg, dev)

    # one copy of the random yi-6b weights, shared by every phase below
    t0 = time.perf_counter()
    params = build_model(cfg).init_params(SEED, dev)
    torch.cuda.synchronize()
    emit({"phase": "weights", "params": cfg.param_count(),
          "init_s": time.perf_counter() - t0,
          "gib": torch.cuda.memory_allocated() / 2 ** 30})
    ekw = {"max_slots": 8, "max_len": 1024}
    rng = np.random.default_rng(SEED)
    batched_counts = phase_batched(cfg, params, dev, ekw, rng)
    rr_counts = phase_rr(cfg, params, dev, ekw, rng)
    phase_logits(cfg, params, dev, rng)

    # -- the kernels line ------------------------------------------------------
    launches = {n: batched_counts[n] + rr_counts[n] for n in batched_counts}
    rows = []
    for name, key in (("flash_attention", ("flash_attention", torch.bfloat16, 0)),
                      ("chunk_attention", ("chunk_attention", torch.bfloat16)),
                      ("packed_chunk_attention",
                       ("packed_chunk_attention", torch.bfloat16))):
        r = kres[key]
        rows.append({"name": name, "route": "cuda", "source": SOURCE[name],
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
