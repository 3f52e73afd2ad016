"""Port parity, layer level: each primitive of ``repro_torch.models.layers``
and each plain attention version of ``repro_torch.kernels.ref`` against the
JAX package on the same numpy inputs, at fp32.

The JAX attention kernels run as the JAX tests run them on the CPU: Pallas
interpret mode through ``repro.kernels.ops.*(backend="interpret")``.
Tolerance: 1e-5 absolute at fp32 (different summation order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL

ATOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=0)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


class _Cfg:
    """The config fields the attention-block primitives read."""
    def __init__(self, H, K, hd, theta=10000.0):
        self.n_heads, self.n_kv_heads, self.head_dim = H, K, hd
        self.rope_theta = theta


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_rms_norm_rope_qkv_out_mlp_match_jax():
    rng = np.random.default_rng(0)
    B, S, d, H, K, hd, ff = 2, 7, 32, 4, 2, 8, 48
    x = _rand(rng, B, S, d)
    w = _rand(rng, d)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w)))

    pos = rng.integers(0, 300, (B, S)).astype(np.int32)
    xh = _rand(rng, B, S, H, hd)
    _close(TL.rope(torch.from_numpy(xh), torch.from_numpy(pos), 10000.0),
           JL.rope(jnp.asarray(xh), jnp.asarray(pos), 10000.0))

    p = {"wq": _rand(rng, d, H * hd), "wk": _rand(rng, d, K * hd),
         "wv": _rand(rng, d, K * hd), "wo": _rand(rng, H * hd, d)}
    cfg = _Cfg(H, K, hd)
    tq = TL.attn_qkv({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), cfg, torch.from_numpy(pos))
    jq = JL.attn_qkv({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), cfg, jnp.asarray(pos))
    for a, b in zip(tq, jq):
        _close(a, b, atol=1e-4)      # d=32 dot products of N(0,1) values
    o = _rand(rng, B, S, H, hd)
    _close(TL.attn_out({"wo": torch.from_numpy(p["wo"])}, torch.from_numpy(o)),
           JL.attn_out({"wo": jnp.asarray(p["wo"])}, jnp.asarray(o)),
           atol=1e-4)

    m = {"wi": _rand(rng, d, ff) * 0.2, "wg": _rand(rng, d, ff) * 0.2,
         "wo": _rand(rng, ff, d) * 0.2}
    for act in ("swiglu", "geglu", "squared_relu"):
        _close(TL.mlp_apply({k: torch.from_numpy(v) for k, v in m.items()},
                            torch.from_numpy(x), act),
               JL.mlp_apply({k: jnp.asarray(v) for k, v in m.items()},
                            jnp.asarray(x), act), atol=1e-4)


def test_cache_writes_match_jax_and_leave_length0_rows_alone():
    rng = np.random.default_rng(1)
    B, S, C, K, hd = 3, 24, 6, 2, 4
    cache = _rand(rng, B, S, K, hd)
    new = _rand(rng, B, C, K, hd)
    offs = np.array([3, 20, 5], np.int32)      # row 1 runs off the cache edge
    lens = np.array([C, 4, 0], np.int32)
    t = torch.from_numpy(cache.copy())
    out = TL.cache_write_chunk(t, torch.from_numpy(new), torch.from_numpy(offs),
                               torch.from_numpy(lens))
    assert out is t                             # in place
    exp = JL.cache_write_chunk(jnp.asarray(cache), jnp.asarray(new),
                               jnp.asarray(offs), jnp.asarray(lens))
    np.testing.assert_array_equal(t.numpy(), np.asarray(exp))
    np.testing.assert_array_equal(t.numpy()[2], cache[2])

    # C == 1 (the decode row) and the one-token writer
    new1 = _rand(rng, B, 1, K, hd)
    t = torch.from_numpy(cache.copy())
    TL.cache_write_chunk(t, torch.from_numpy(new1), torch.from_numpy(offs),
                         torch.from_numpy(np.array([1, 0, 1], np.int32)))
    exp = JL.cache_write_chunk(jnp.asarray(cache), jnp.asarray(new1),
                               jnp.asarray(offs),
                               jnp.asarray(np.array([1, 0, 1], np.int32)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(exp))
    sl = np.array([0, 23, 24], np.int32)        # the last is past the edge
    t = torch.from_numpy(cache.copy())
    TL.cache_write_token(t, torch.from_numpy(new1[:, 0]), torch.from_numpy(sl))
    exp = JL.cache_write_token(jnp.asarray(cache), jnp.asarray(new1[:, 0]),
                               jnp.asarray(sl))
    np.testing.assert_array_equal(t.numpy(), np.asarray(exp))

    # packed: unaligned rows, a length-0 row, tail padding
    starts = np.array([0, 5, 5], np.int32)
    plens = np.array([5, 0, 3], np.int32)
    poffs = np.array([2, 9, 18], np.int32)
    Np = 11
    pnew = _rand(rng, Np, K, hd)
    row, off, valid = TL.packed_row_index(torch.from_numpy(starts),
                                          torch.from_numpy(plens), Np)
    jrow, joff, jvalid = JL.packed_row_index(jnp.asarray(starts),
                                             jnp.asarray(plens), Np)
    np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    t = torch.from_numpy(cache.copy())
    TL.cache_write_packed(t, torch.from_numpy(pnew), torch.from_numpy(starts),
                          torch.from_numpy(poffs), torch.from_numpy(plens))
    pos = poffs[np.asarray(jrow)] + np.asarray(joff)
    exp = JL.cache_write_packed(jnp.asarray(cache), jnp.asarray(pnew), jrow,
                                jnp.asarray(pos), jvalid)
    np.testing.assert_array_equal(t.numpy(), np.asarray(exp))
    np.testing.assert_array_equal(t.numpy()[1], cache[1])


# ---------------------------------------------------------------------------
# attention: plain versions vs the JAX plain versions and Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("H,K", [(4, 2), (4, 4)])
def test_flash_attention_matches_jax(window, H, K):
    rng = np.random.default_rng(2)
    B, S, hd = 2, 64, 16
    q, k, v = _rand(rng, B, S, H, hd), _rand(rng, B, S, K, hd), \
        _rand(rng, B, S, K, hd)
    offs = np.array([0, 5], np.int32)
    klens = np.array([64, 50], np.int32)
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), window=window,
                               q_offsets=torch.from_numpy(offs),
                               kv_lens=torch.from_numpy(klens))
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kw = dict(window=window, q_offsets=jnp.asarray(offs),
              kv_lens=jnp.asarray(klens))
    _close(got, jref.flash_attention_ref(*args, **kw))
    _close(got, jops.flash_attention(*args, backend="interpret", block_q=32,
                                     block_k=32, **kw))
    # the model's entry point (shared offset, full kv)
    _close(TL.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), window=window),
           jref.flash_attention_ref(*args, window=window))


@pytest.mark.parametrize("window", [0, 20])
def test_chunk_attention_matches_jax_on_mixed_rows(window):
    """Rows [C, 1, 0]: a prefill chunk, a decode row, an idle row."""
    rng = np.random.default_rng(3)
    B, C, S, H, K, hd = 3, 16, 64, 4, 2, 16
    q = _rand(rng, B, C, H, hd)
    kc, vc = _rand(rng, B, S, K, hd), _rand(rng, B, S, K, hd)
    offs = np.array([10, 40, 0], np.int32)
    qlens = np.array([C, 1, 0], np.int32)
    targs = (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
             torch.from_numpy(offs))
    got = TL.chunk_attention(*targs, q_lens=torch.from_numpy(qlens),
                             window=window)
    jargs = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
             jnp.asarray(offs), jnp.asarray(qlens))
    exp = jref.chunk_attention_ref(*jargs, window=window)
    ker = jops.chunk_attention(*jargs, window=window, backend="interpret",
                               block_q=8, block_k=16)
    for b in range(B):
        n = qlens[b]
        _close(got[b, :n], exp[b, :n])
        _close(got[b, :n], ker[b, :n])
        assert not got[b, n:].any()             # dead rows are zeros
    # the C == 1 case is decode attention
    dq = q[:, 0]
    sl = offs + 1
    _close(tops.decode_attention(torch.from_numpy(dq), torch.from_numpy(kc),
                                 torch.from_numpy(vc), torch.from_numpy(sl),
                                 window=window),
           jops.decode_attention(jnp.asarray(dq), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(sl),
                                 window=window, backend="interpret",
                                 block_k=16))


@pytest.mark.parametrize("window", [0, 24])
def test_packed_chunk_attention_matches_jax(window):
    """Aligned rows against the Pallas kernel (interpret), unaligned rows
    against the JAX plain version; gaps and tail padding are zeros."""
    rng = np.random.default_rng(4)
    B, S, H, K, hd = 4, 96, 4, 2, 16
    qlens = np.array([16, 1, 0, 5], np.int32)
    offs = np.array([10, 40, 0, 63], np.int32)
    kc, vc = _rand(rng, B, S, K, hd), _rand(rng, B, S, K, hd)
    for align in (8, 1):
        starts = np.zeros(B, np.int32)
        cur = 0
        for b in range(B):
            starts[b] = cur
            cur += -(-int(qlens[b]) // align) * align
        Np = cur + 3                                     # tail padding
        q = _rand(rng, Np, H, hd)
        targs = [torch.from_numpy(a) for a in (q, kc, vc, starts, offs, qlens)]
        got = TL.packed_chunk_attention(*targs, window=window)
        jargs = [jnp.asarray(a) for a in (q, kc, vc, starts, offs, qlens)]
        exp = jref.packed_chunk_attention_ref(*jargs, window=window)
        live = np.zeros(Np, bool)
        for b in range(B):
            live[starts[b]:starts[b] + qlens[b]] = True
        _close(_np(got)[live], _np(exp)[live])
        assert not _np(got)[~live].any()
        if align == 8:
            ker = jops.packed_chunk_attention(*jargs, window=window,
                                              backend="interpret", block_q=8,
                                              block_k=32)
            _close(_np(got)[live], _np(ker)[live])


def test_packed_equals_padded_rows_within_torch():
    """The packed layout is a re-indexing: each packed row equals the padded
    chunk row over the same cache, bit for bit."""
    rng = np.random.default_rng(5)
    B, C, S, H, K, hd = 3, 16, 96, 4, 2, 16
    qlens = np.array([C, 1, 7], np.int32)
    starts = np.array([0, C, C + 1], np.int32)
    qpad = _rand(rng, B, C, H, hd)
    kc, vc = _rand(rng, B, S, K, hd), _rand(rng, B, S, K, hd)
    offs = np.array([10, 40, 0], np.int32)
    qflat = np.concatenate([qpad[b, :qlens[b]] for b in range(B)])
    packed = tref.packed_chunk_attention_ref(
        *[torch.from_numpy(a) for a in (qflat, kc, vc, starts, offs, qlens)])
    padded = tref.chunk_attention_ref(
        *[torch.from_numpy(a) for a in (qpad, kc, vc, offs, qlens)])
    for b in range(B):
        np.testing.assert_array_equal(
            packed[starts[b]:starts[b] + qlens[b]].numpy(),
            padded[b, :qlens[b]].numpy())


def test_ops_route_cpu_tensors_to_plain_and_reject_unknown_backend():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 8, 2, 16)) for _ in range(3))
    np.testing.assert_array_equal(
        tops.flash_attention(q, k, v).numpy(),
        tref.flash_attention_ref(q, k, v).numpy())
    np.testing.assert_array_equal(
        tops.flash_attention(q, k, v, backend="torch").numpy(),
        tref.flash_attention_ref(q, k, v).numpy())
    with pytest.raises(ValueError):
        tops.flash_attention(q, k, v, backend="cuda_please")
    before = tops.launch_counts()
    tops.chunk_attention(q, k, v, torch.zeros(1, dtype=torch.int32))
    assert tops.launch_counts() == before      # plain versions never count
