"""Port parity, model level: ``repro_torch`` DenseTransformer entry points
against the JAX package's DenseTransformer on the same weights (JAX init ->
numpy -> ``params_from_numpy``) and the same numpy inputs, at fp32, for the
``tiny`` config and the yi-6b SMOKE config.

Across frameworks logits and every cache leaf agree within a tolerance
(fp32, different summation order). Within torch the per-row contract of the
mixed dispatch: a length-0 row is a strict no-op and a prefill row does not
depend on the batch it rides in (bit for bit); a C == 1 dispatch (the
engine's decode tick) equals ``decode_step`` bit for bit. Where the token
count of the dispatch differs -- a decode row inside a wider chunk, packed
against padded -- the CPU matmul takes other blocking paths (MKL's
single-row product is a gemv), so those agree to 1e-5, not bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_config as torch_config
from repro_torch.models import build_model as torch_build
from repro_torch.models.convert import params_from_numpy

ARCHS = ["tiny", "yi-6b"]
LOGIT_ATOL = 2e-5     # fp32: two layers, d=64, a 256..512-wide head
CACHE_ATOL = 1e-5
B, MAX_LEN, P, C = 3, 64, 13, 8


def _cfgs(arch):
    smoke = arch != "tiny"
    jc = jax_config(arch, smoke=smoke).replace(dtype=jnp.float32,
                                               param_dtype=jnp.float32)
    tc = torch_config(arch, smoke=smoke).replace(dtype=torch.float32,
                                                 param_dtype=torch.float32)
    return jc, tc


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax model, jax params, torch model, torch params) sharing weights."""
    jc, tc = _cfgs(request.param)
    jm, tm = jax_build(jc), torch_build(tc)
    jp, _ = jm.init_params(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jm, jp, tm, tp


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _assert_cache_close(jcache, tcache):
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   atol=CACHE_ATOL, rtol=0, err_msg=k)
    np.testing.assert_array_equal(tcache["seq_lens"].numpy(),
                                  np.asarray(jcache["seq_lens"]))


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _prefilled(pair):
    """Both caches after a P-token prefill of every row, plus the logits."""
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(0).integers(1, 200, (B, P)).astype(np.int32)
    lengths = np.full((B,), P, np.int32)
    jcache, _ = jm.init_cache(B, MAX_LEN)
    jcache, jl = jm.prefill(jp, jnp.asarray(toks), jcache,
                            lengths=jnp.asarray(lengths))
    tcache, tl = tm.prefill(tp, _t(toks), tm.init_cache(B, MAX_LEN, "cpu"),
                            lengths=_t(lengths))
    return jcache, jl, tcache, tl


def test_prefill_matches_jax(pair):
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(3).integers(1, 200, (2, 32)).astype(np.int32)
    lengths = np.array([32, 19], np.int32)      # right-padded second row
    jcache, _ = jm.init_cache(2, MAX_LEN)
    jcache, jl = jm.prefill(jp, jnp.asarray(toks), jcache,
                            lengths=jnp.asarray(lengths))
    tcache, tl = tm.prefill(tp, _t(toks), tm.init_cache(2, MAX_LEN, "cpu"),
                            lengths=_t(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    _assert_cache_close(jcache, tcache)


def test_prefill_chunk_rows_c_1_0_match_jax(pair):
    jm, jp, tm, tp = pair
    jcache, jl, tcache, tl = _prefilled(pair)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    buf = np.zeros((B, C), np.int32)
    buf[0] = np.random.default_rng(1).integers(1, 200, C)
    buf[1, 0] = nxt[1]
    lengths = np.array([C, 1, 0], np.int32)
    offs = np.array([P, P, 0], np.int32)
    for kv in (None, 32):
        jc2, jl2 = jm.prefill_chunk(jp, jnp.asarray(buf), jcache,
                                    q_offset=jnp.asarray(offs),
                                    lengths=jnp.asarray(lengths), kv_width=kv)
        tc2, tl2 = tm.prefill_chunk(tp, _t(buf), _clone(tcache),
                                    q_offset=_t(offs), lengths=_t(lengths),
                                    kv_width=kv)
        np.testing.assert_allclose(tl2.numpy()[:2], np.asarray(jl2)[:2],
                                   atol=LOGIT_ATOL, rtol=0)
        _assert_cache_close(jc2, tc2)


def test_prefill_packed_and_decode_step_match_jax(pair):
    jm, jp, tm, tp = pair
    jcache, jl, tcache, tl = _prefilled(pair)
    # unaligned packed rows: 5 tokens, an idle row, 1 decode token, padding
    lengths = np.array([5, 0, 1], np.int32)
    starts = np.array([0, 5, 5], np.int32)
    offs = np.array([P, 0, P], np.int32)
    flat = np.random.default_rng(2).integers(1, 200, 8).astype(np.int32)
    jc2, jl2 = jm.prefill_packed(jp, jnp.asarray(flat), jcache,
                                 row_starts=jnp.asarray(starts),
                                 q_offset=jnp.asarray(offs),
                                 lengths=jnp.asarray(lengths), kv_width=32)
    tc2, tl2 = tm.prefill_packed(tp, _t(flat), tcache, row_starts=_t(starts),
                                 q_offset=_t(offs), lengths=_t(lengths),
                                 kv_width=32)
    np.testing.assert_allclose(tl2.numpy()[[0, 2]], np.asarray(jl2)[[0, 2]],
                               atol=LOGIT_ATOL, rtol=0)
    _assert_cache_close(jc2, tc2)
    tok = np.array([7, 9, 11], np.int32)
    jc3, jl3 = jm.decode_step(jp, jnp.asarray(tok), jc2)
    tc3, tl3 = tm.decode_step(tp, _t(tok), tc2)
    np.testing.assert_allclose(tl3.numpy(), np.asarray(jl3), atol=LOGIT_ATOL,
                               rtol=0)
    _assert_cache_close(jc3, tc3)


def _rows_equal(a, b, rows):
    for k in ("k", "v"):
        assert torch.equal(a[k][:, rows], b[k][:, rows]), k
    assert torch.equal(a["seq_lens"][rows], b["seq_lens"][rows])


def test_per_row_contract_within_torch(pair):
    """Lengths [C, 1, 0] in one dispatch: the idle row is untouched, the
    prefill row does not depend on batch composition, the decode row matches
    decode_step; a C == 1 dispatch is decode_step bit for bit; packed ==
    padded on valid rows."""
    jm, jp, tm, tp = pair
    _, _, cache, logits = _prefilled(pair)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    cache_dec, logits_dec = tm.decode_step(tp, nxt, _clone(cache))

    cache_c1, logits_c1 = tm.prefill_chunk(
        tp, nxt[:, None], _clone(cache), q_offset=cache["seq_lens"].clone(),
        lengths=torch.tensor([1, 1, 0], dtype=torch.int32))
    assert torch.equal(logits_c1[:2], logits_dec[:2])
    _rows_equal(cache_c1, cache_dec, [0, 1])
    _rows_equal(cache_c1, cache, [2])

    buf = np.zeros((B, C), np.int32)
    buf[0] = np.random.default_rng(1).integers(1, 200, C)
    buf[1, 0] = int(nxt[1])
    lengths = np.array([C, 1, 0], np.int32)
    offs = np.array([P, P, 0], np.int32)
    cache_mix, logits_mix = tm.prefill_chunk(
        tp, _t(buf), _clone(cache), q_offset=_t(offs), lengths=_t(lengths))
    torch.testing.assert_close(logits_mix[1], logits_dec[1], atol=1e-5,
                               rtol=0)
    for k in ("k", "v"):
        torch.testing.assert_close(cache_mix[k][:, 1], cache_dec[k][:, 1],
                                   atol=1e-5, rtol=0)
    _rows_equal(cache_mix, cache, [2])
    cache_solo, logits_solo = tm.prefill_chunk(
        tp, _t(buf), _clone(cache), q_offset=_t(offs),
        lengths=_t(np.array([C, 0, 0], np.int32)))
    assert torch.equal(logits_mix[0], logits_solo[0])
    _rows_equal(cache_mix, cache_solo, [0])

    starts = np.array([0, C, C + 1], np.int32)
    flat = np.zeros((16,), np.int32)
    flat[:C] = buf[0]
    flat[C] = buf[1, 0]
    cache_pk, logits_pk = tm.prefill_packed(
        tp, _t(flat), _clone(cache), row_starts=_t(starts), q_offset=_t(offs),
        lengths=_t(lengths))
    torch.testing.assert_close(logits_pk[:2], logits_mix[:2], atol=1e-5,
                               rtol=0)
    for k in ("k", "v"):
        torch.testing.assert_close(cache_pk[k], cache_mix[k], atol=1e-5,
                                   rtol=0)
    _rows_equal(cache_pk, cache, [2])


def test_params_from_numpy_carries_bf16_bits():
    """The JAX package's bf16 weights (``ml_dtypes.bfloat16`` arrays, which
    ``torch.from_numpy`` refuses) cross bit for bit; a tree of another
    model is refused."""
    jp, _ = jax_build(jax_config("tiny")).init_params(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(tree, torch_config("tiny"), "cpu")
    for j, t in ((tree["embed"], tp["embed"]),
                 (tree["blocks"]["attn"]["wq"], tp["blocks"]["attn"]["wq"])):
        assert j.dtype.name == "bfloat16" and t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      j.view(np.int16))
    with pytest.raises(ValueError, match="does not match"):
        params_from_numpy(tree, torch_config("yi-6b", smoke=True), "cpu")
