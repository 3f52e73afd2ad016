"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA GPU and nvcc, and skip elsewhere (the
CPU tests cover the plain versions against the JAX package). On a machine
with a card, from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest releases JAX caches, and the card's
machine has no JAX; this file imports none.) Shapes are small and cover what
``chip_smoke.py`` does not: every supported head_dim, MHA to wide GQA,
windows, unaligned packed rows, strided cache views, and a CUDA engine run
against the same engine on the CPU.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def _close(got, ref, sel=None):
    """Kernel against plain version on the selected rows. fp32: 1e-4
    absolute (summation order). bf16: both round an fp32 result to bf16, so
    they may differ by one bf16 ulp of the output, 2**-7 of the largest
    |output| (plus fp32 noise)."""
    d = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    if sel is not None:
        d, r = d[sel], r[sel]
    tol = 1e-4 if ref.dtype == torch.float32 else 2.0 ** -7 * r.max().item() + 1e-5
    assert d.max().item() <= tol


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import ops
    ops.ensure_built()


def _rand(g, *shape, dtype):
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def _i32(a):
    return torch.as_tensor(np.asarray(a, np.int32), device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("H,K", [(4, 4), (4, 2), (32, 4)])
@pytest.mark.parametrize("window", [0, 24])
def test_flash_and_chunk_match_plain(dtype, hd, H, K, window):
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(hd * 7 + H + window)
    B, S = 2, 100
    q, k, v = _rand(g, B, S, H, hd, dtype=dtype), _rand(g, B, S, K, hd, dtype=dtype), \
        _rand(g, B, S, K, hd, dtype=dtype)
    offs, klens = _i32([0, 9]), _i32([100, 61])
    before = ops.launch_counts()
    got = ops.flash_attention(q, k, v, window=window, q_offsets=offs,
                              kv_lens=klens)
    ref = ops.flash_attention(q, k, v, window=window, q_offsets=offs,
                              kv_lens=klens, backend="torch")
    torch.cuda.synchronize()
    # rows whose window lies wholly past kv_len see no key: the kernel writes
    # zeros there and the plain version a meaningless average; skip them
    qpos = offs.long()[:, None] + torch.arange(S, device="cuda")[None]
    has_key = torch.minimum(qpos, klens.long()[:, None] - 1) > (
        qpos - window if window else qpos.new_full(qpos.shape, -1))
    _close(got, ref, has_key)

    # chunk rows [C, 1, 0, tail] over a strided view of a wider cache
    C, Sfull = 20, 160
    kc = _rand(g, 4, Sfull, K, hd, dtype=dtype)[:, :96]
    vc = _rand(g, 4, Sfull, K, hd, dtype=dtype)[:, :96]
    qc = _rand(g, 4, C, H, hd, dtype=dtype)
    qlens, coffs = _i32([C, 1, 0, 7]), _i32([30, 95, 3, 60])
    got = ops.chunk_attention(qc, kc, vc, coffs, qlens, window=window)
    ref = ops.chunk_attention(qc, kc, vc, coffs, qlens, window=window,
                              backend="torch")
    torch.cuda.synchronize()
    live = torch.arange(C, device="cuda")[None] < qlens.long()[:, None]
    _close(got, ref, live)
    assert not got[~live].any()
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["chunk_attention"] == before["chunk_attention"] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H,K", [(16, 4, 2), (128, 32, 4), (64, 8, 8)])
def test_packed_and_decode_match_plain(dtype, hd, H, K):
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(hd + H)
    B, S = 6, 128
    kc = _rand(g, B, S, K, hd, dtype=dtype)
    vc = _rand(g, B, S, K, hd, dtype=dtype)
    plens = np.array([37, 1, 0, 64, 1, 5], np.int32)
    starts = np.concatenate([[0], np.cumsum(plens)[:-1]]).astype(np.int32)
    Np = 128
    q = _rand(g, Np, H, hd, dtype=dtype)
    offs = _i32([3, 120, 0, 60, 44, 122])
    got = ops.packed_chunk_attention(q, kc, vc, _i32(starts), offs, _i32(plens))
    ref = ops.packed_chunk_attention(q, kc, vc, _i32(starts), offs, _i32(plens),
                                     backend="torch")
    torch.cuda.synchronize()
    live = np.zeros(Np, bool)
    for b in range(B):
        live[starts[b]:starts[b] + plens[b]] = True
    live = torch.as_tensor(live, device="cuda")
    _close(got, ref, live)
    assert not got[~live].any()

    seq = _i32([128, 1, 77, 5, 100, 3])
    qd = _rand(g, B, H, hd, dtype=dtype)
    got = ops.decode_attention(qd, kc, vc, seq)
    ref = ops.decode_attention(qd, kc, vc, seq, backend="torch")
    torch.cuda.synchronize()
    _close(got, ref)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    from repro_torch.kernels import ops
    q = torch.zeros((1, 4, 2, 24), device="cuda")           # head_dim 24
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q, q)
    q = torch.zeros((1, 4, 2, 16), device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q, q, q)
    q = torch.zeros((1, 4, 2, 16), device="cuda")
    with pytest.raises(ValueError, match="int32"):
        ops.chunk_attention(q, q, q, torch.zeros(1, dtype=torch.int64,
                                                 device="cuda"))


def test_cuda_engine_matches_cpu_engine_at_fp32():
    """The whole serving path on the card (flash, chunk and packed kernels)
    gives the CPU engine's greedy tokens on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.transformer import tree_map
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("tiny").replace(dtype=torch.float32,
                                     param_dtype=torch.float32)
    params = build_model(cfg).init_params(0, "cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 500, n).astype(np.int32) for n in (8, 33, 70)]

    def run(device):
        p = tree_map(lambda t: t.to(device), params)
        eng = ServingEngine(cfg, max_slots=4, max_len=128, params=p,
                            device=device)
        first = eng.add_sequence(prompts[0], max_new=6)       # eager: flash
        slots = eng.add_sequences([dict(prompt=q, max_new=6)
                                   for q in prompts[1:]], eager=False)
        while any(not eng.is_done(s) for s in [first] + slots):
            eng.serve_step()
        return [eng.result(s) for s in [first] + slots]

    ops.reset_launch_counts()
    got = run("cuda")
    counts = ops.launch_counts()
    assert got == run("cpu")
    assert all(n > 0 for n in counts.values()), counts
