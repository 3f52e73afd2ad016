"""Continuous-batching serving engine with preemption (context snapshot /
restore): the port of ``repro/serving/engine.py`` on the legacy blob path
(no page store, no prefix cache, no speculative decoding, no image rows).

Fixed decode-slot batch: ``max_slots`` sequences share one KV cache
``[L, max_slots, max_len, K, hd]`` on the device, updated in place.
Admission is batched chunked prefill: admitted prompts join a prefill
queue. In the default unified mode (``serve_step``) every scheduler tick is
ONE model dispatch: queued prefill jobs consume a token chunk, every
decoding slot rides in the same batch as a length-1 chunk row at its
current position, and untouched slots are length-0 rows the model leaves
bit-for-bit alone. When the real tokens fit a smaller bucket than the
padded ``[kb, C]`` rectangle, the dispatch goes token-packed
(``prefill_packed``). ``mixed_step=False`` keeps the interleaved pair (chunk
dispatch, then a guarded decode dispatch) and ``serial_prefill=True`` the
one-sequence-per-call prefill: the baselines the parity tests replay.

Packed rows start at their real offsets (alignment 1) on every device: the
CUDA packed kernel finds each query position's row itself, so the packed
or padded choice is the one the JAX engine makes with ``use_kernel=False``.

Sampling invariants (what makes a context switch exact):
  * every sequence has its own seed; draw #n depends on (seed, n) only;
  * ``next_tokens[slot]`` holds the pending token: sampled, not yet fed;
  * ``counter`` = number of tokens sampled so far = len(generated) + 1.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.obs.profiler import (KIND_DECODE, KIND_PACKED, KIND_PADDED,
                                      KIND_SERIAL)
from repro_torch.serving import sampler as smp
from repro_torch.serving.paging import PageAllocator

# fixed chunk-size buckets for batched chunked prefill
PREFILL_CHUNKS = (32, 64, 128, 256)

# total-token buckets for the packed ragged dispatch (powers of two)
PACKED_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 4095) // 4096) * 4096


def seq_seed(prompt: np.ndarray) -> int:
    """Default per-sequence sampling seed (the JAX engine's formula)."""
    return (int(np.sum(prompt)) * 2654435761 + len(prompt)) % (2 ** 31)


@dataclasses.dataclass
class ContextSnapshot:
    """Paper §3.4 context. kind="logits": exact decode state (the slot's
    live K/V on the host + pending token). kind="text": token ids only;
    restore re-prefills and re-draws the pending token from the same
    per-sequence stream."""
    kind: str
    prompt: np.ndarray
    generated: List[int]
    seq_len: int
    seq_seed: int = 0
    counter: int = 0
    state: Optional[List[torch.Tensor]] = None   # host k, v [L, seq_len, K, hd]
                                                 # and seq_lens [1]
    pending_token: Optional[int] = None
    origin: Optional[int] = None   # engine_id that produced the state
    max_new: int = 32
    eos_id: int = -1

    def nbytes(self) -> int:
        n = self.prompt.nbytes + 8 * len(self.generated)
        if self.state is not None:
            n += sum(t.numel() * t.element_size() for t in self.state)
        return n


class _Slot:
    __slots__ = ("active", "prefilling", "seq_id", "prompt", "generated",
                 "counter", "max_new", "eos_id", "sink", "prefilled")

    def __init__(self):
        self.active = False
        self.prefilling = False   # admitted, prompt not fully consumed yet
        self.seq_id = None
        self.prompt = None
        self.generated: List[int] = []
        self.counter = 0
        self.max_new = 0
        self.eos_id = -1
        self.prefilled = 0        # prompt tokens this admission prefilled
        self.sink = None          # per-token callback (streaming syscalls)


class _PendingPrefill:
    """One queued chunked-prefill job: feed tokens[done:] into `slot`."""
    __slots__ = ("slot", "tokens", "done", "fresh")

    def __init__(self, slot: int, tokens: np.ndarray, done: int, fresh: bool):
        self.slot = slot
        self.tokens = tokens
        self.done = done
        self.fresh = fresh


def _not_ported(name: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} is not ported to repro_torch yet (ROADMAP.md Queue 1: {item})")


class ServingEngine:
    def __init__(self, cfg, *, max_slots: int = 8, max_len: int = 512,
                 temperature: float = 0.0, rng_seed: int = 0,
                 page_size: int = 16, hbm_pages: Optional[int] = None,
                 params=None, prefix_cache=None, serial_prefill: bool = False,
                 prefill_chunk_cap: Optional[int] = None, engine_id: int = 0,
                 page_store=None, mixed_step: Optional[bool] = None,
                 packed_step: Optional[bool] = None, tracer=None,
                 profiler=None, spec_decode: bool = False, device=None):
        if prefix_cache is not None or page_store is not None:
            raise _not_ported("the prefix cache / paged KV store",
                              "paged KV hierarchy and prefix cache")
        if tracer is not None:
            raise _not_ported("engine tracing", "control/obs/replay")
        if spec_decode:
            raise _not_ported("speculative decoding", "speculative decoding")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        if self.device.type == "cuda":
            kops.ensure_built()          # on the constructor's thread
        self.profiler = profiler
        self.engine_id = engine_id
        self.serial_prefill = serial_prefill
        self.mixed = (not serial_prefill) if mixed_step is None \
            else bool(mixed_step)
        self.packed = (not serial_prefill) if packed_step is None \
            else bool(packed_step)
        self.max_slots = max_slots
        self.max_len = max_len
        self.temperature = temperature
        if params is None:
            params = self.model.init_params(rng_seed, self.device)
        else:
            dev = params["embed"].device
            if dev.type != self.device.type:
                raise ValueError(f"params live on {dev}, engine on {self.device}")
        self.params = params
        self.cache = self.model.init_cache(max_slots, max_len, self.device)
        self.slots = [_Slot() for _ in range(max_slots)]
        self.seq_seeds = [0] * max_slots
        self.next_tokens = torch.zeros((max_slots,), dtype=torch.int32,
                                       device=self.device)
        pages = hbm_pages if hbm_pages is not None else max_slots * (
            -(-max_len // page_size))
        k = self.cache["k"]
        self.kv_bytes_per_token = 2 * k[:, 0, 0].numel() * k.element_size()
        self.pager = PageAllocator(pages, page_size, self.kv_bytes_per_token)
        self._lock = threading.Lock()
        self._prefill_queue: List[_PendingPrefill] = []
        cap = min(max_len, prefill_chunk_cap or max_len)
        self.prefill_chunks = tuple(
            c for c in PREFILL_CHUNKS if c <= cap) or (PREFILL_CHUNKS[0],)
        self.kv_buckets = tuple(sorted({min(64, max_len), min(256, max_len),
                                        max_len}))
        self.stats = {"decode_steps": 0, "prefills": 0, "tokens": 0,
                      "preemptions": 0, "restores": 0,
                      "prefill_chunks": 0, "prefill_bursts": 0,
                      "batched_prefill_tokens": 0,
                      "model_dispatches": 0, "mixed_steps": 0,
                      "mixed_decode_rows": 0,
                      "packed_dispatches": 0, "packed_tokens": 0,
                      "packed_padded_tokens": 0}

    def _t(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- slot management ----------------------------------------------------------
    def free_slot_count(self) -> int:
        return sum(not s.active for s in self.slots)

    def _find_free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if not s.active:
                return i
        return None

    def active_slots(self) -> List[int]:
        """Slots that decode this step (admitted AND done prefilling)."""
        return [i for i, s in enumerate(self.slots)
                if s.active and not s.prefilling]

    def is_prefilling(self, slot: int) -> bool:
        return self.slots[slot].prefilling

    def prefill_pending(self) -> int:
        return len(self._prefill_queue)

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        return (self._find_free_slot() is not None and
                prompt_len + max_new <= self.max_len and
                self.pager.can_admit(prompt_len + max_new))

    def _slot_view(self, slot: int):
        """Batch-1 view of one slot's cache rows (writes land in place)."""
        return {"k": self.cache["k"][:, slot:slot + 1],
                "v": self.cache["v"][:, slot:slot + 1],
                "seq_lens": self.cache["seq_lens"][slot:slot + 1]}

    # -- admission ------------------------------------------------------------------
    def add_sequence(self, prompt, *, seq_id=None, max_new: int = 32,
                     eos_id: int = -1, seq_key=None, image_embeds=None,
                     eager: bool = True, sink=None) -> int:
        return self.add_sequences(
            [dict(prompt=prompt, seq_id=seq_id, max_new=max_new,
                  eos_id=eos_id, seq_key=seq_key, image_embeds=image_embeds,
                  sink=sink)],
            eager=eager)[0]

    def add_sequences(self, requests, *, eager: bool = True) -> List[int]:
        """Admit a burst of sequences. Each request is a dict with ``prompt``
        plus optional ``seq_id``/``max_new``/``eos_id``/``seq_key`` (an int
        sampling seed)/``sink``. Prompts join the chunked-prefill queue so
        the burst shares one dispatch per chunk; with ``eager`` the queue is
        drained before returning (a lone eager prompt takes the serial
        prefill). Raises on the first request that cannot be admitted;
        requests before it stay admitted."""
        slots: List[int] = []
        if len(requests) > 1:
            self.stats["prefill_bursts"] += 1
        admitted, err = [], None
        for r in requests:
            if r.get("image_embeds") is not None:
                raise _not_ported("image prompts", "VLM")
            prompt = np.asarray(r["prompt"], dtype=np.int32)
            P = len(prompt)
            max_new = r.get("max_new", 32)
            with self._lock:
                slot = self._find_free_slot()
                if slot is None:
                    err = RuntimeError("no free decode slot")
                    break
                if P + max_new > self.max_len:
                    err = RuntimeError(
                        f"context {P + max_new} > max_len {self.max_len}")
                    break
                if not self.pager.reserve(f"slot{slot}", P + max_new):
                    err = RuntimeError("device KV pages exhausted")
                    break
                s = self.slots[slot]
                s.active = True
                s.prefilling = False
                s.seq_id = r.get("seq_id")
                s.prompt = prompt
                s.generated = []
                s.counter = 0
                s.max_new = max_new
                s.eos_id = r.get("eos_id", -1)
                s.sink = r.get("sink")
                s.prefilled = P
            key = r.get("seq_key")
            self.seq_seeds[slot] = seq_seed(prompt) if key is None else int(key)
            admitted.append((slot, prompt))
            slots.append(slot)
        if err is not None:
            err.admitted_slots = list(slots)
        if not admitted:
            if err is not None:
                raise err
            return []
        for slot, prompt in admitted:
            self.stats["prefills"] += 1
            if self.serial_prefill or (eager and len(admitted) == 1
                                       and not self._prefill_queue):
                # one full single-sequence prefill (the flash-attention path)
                self._prefill_into(slot, prompt)
            else:
                self._enqueue_prefill(slot, prompt, done=0, fresh=True)
        if eager:
            while self._prefill_queue:
                self.prefill_step()
        if err is not None:
            raise err
        return slots

    def _enqueue_prefill(self, slot: int, tokens: np.ndarray, *, done: int,
                         fresh: bool):
        self.slots[slot].prefilling = True
        with self._lock:
            self._prefill_queue.append(
                _PendingPrefill(slot, np.asarray(tokens, np.int32), done, fresh))

    def prefill_step(self) -> List[int]:
        """Consume ONE token chunk for every queued prefill job in a single
        dispatch -- the decode-free case of ``_mixed_dispatch``. Returns the
        slots whose prompt completed (they are activated)."""
        with self._lock:
            jobs = list(self._prefill_queue)
        if not jobs:
            return []
        self._mixed_dispatch(jobs, decode=())
        return [j.slot for j in jobs if j.done >= len(j.tokens)]

    def _prefill_into(self, slot: int, tokens: np.ndarray):
        """Prefill `tokens` straight into `slot`'s cache rows and sample the
        pending token with the slot's current counter."""
        P = len(tokens)
        _t0 = self._obs_t0()
        Spad = min(_bucket(P), self.max_len)
        buf = np.zeros((1, Spad), np.int32)
        buf[0, :P] = tokens
        _, logits = self.model.prefill(self.params, self._t(buf),
                                       self._slot_view(slot),
                                       lengths=self._t([P]))
        self.stats["model_dispatches"] += 1
        self._activate_in_place(slot, logits[0])
        if _t0:
            self._obs_tick(KIND_SERIAL, _t0, _t0, 1, 1, Spad, Spad, P, Spad)

    def _sample(self, logits, slots: List[int]):
        """Pending tokens for `slots` from their rows of `logits`, each with
        the slot's own seed and counter."""
        logits = smp.mask_padded_vocab(logits, self.cfg.vocab)
        return smp.sample(logits, [self.seq_seeds[s] for s in slots],
                          [self.slots[s].counter for s in slots],
                          self.temperature)

    def _activate_in_place(self, slot: int, logits_vec):
        s = self.slots[slot]
        s.prefilling = False
        self.next_tokens[slot] = self._sample(logits_vec[None], [slot])[0]
        s.counter += 1

    # -- observability ----------------------------------------------------------------
    def _obs_t0(self) -> float:
        return 0.0 if self.profiler is None else time.perf_counter()

    def _obs_tick(self, kind: int, t0: float, t_build: float, rows: int,
                  kb: int, chunk: int, kv: int, tokens: int,
                  padded: int) -> None:
        self.profiler.record(kind, time.perf_counter() - t0, t_build - t0,
                             rows, kb, chunk, kv, int(tokens), int(padded))

    # -- decode / unified serve ------------------------------------------------------
    def step(self) -> Dict[int, int]:
        """One decode step for all active slots: feed each slot's pending
        token (appending it to `generated`) and sample the next pending.
        In mixed mode this is the C == 1 chunk dispatch; legacy mode runs
        ``decode_step`` and restores the inactive rows afterwards."""
        active = self.active_slots()
        if not active:
            return {}
        _t0 = self._obs_t0()
        kvb = self.max_len
        mask_np = np.zeros(self.max_slots, bool)
        mask_np[active] = True
        mask = self._t(mask_np, torch.bool)
        tokens = self.next_tokens
        tok_host = tokens.tolist()       # a copy: next_tokens is updated below
        if self.mixed:
            # a slot decoding past the cache edge keeps stepping with its
            # write dropped, as in the JAX engine
            max_end = min(self.max_len,
                          1 + max(len(self.slots[i].prompt) +
                                  len(self.slots[i].generated)
                                  for i in active))
            kvb = next(b for b in self.kv_buckets if b >= max_end)
            toks = torch.where(mask, tokens, torch.zeros_like(tokens))[:, None]
            _, logits = self.model.prefill_chunk(
                self.params, toks, self.cache,
                q_offset=self.cache["seq_lens"].clone(),
                lengths=mask.to(torch.int32), kv_width=kvb)
            self.stats["mixed_steps"] += 1
            self.stats["mixed_decode_rows"] += len(active)
        else:
            logits = self._guarded_decode(tokens, active)
        act = self._t(active, torch.long)
        self.next_tokens[act] = self._sample(logits[act], active)
        emitted: Dict[int, int] = {}
        for i in active:
            s = self.slots[i]
            t = int(tok_host[i])
            s.generated.append(t)
            if s.sink is not None:
                s.sink(t)
            s.counter += 1
            emitted[i] = t
            self.pager.grow(f"slot{i}", len(s.prompt) + len(s.generated) + 1)
        self.stats["decode_steps"] += 1
        self.stats["model_dispatches"] += 1
        self.stats["tokens"] += len(active)
        if _t0:
            self._obs_tick(KIND_DECODE, _t0, _t0, len(active),
                           self.max_slots, 1, kvb, len(active),
                           self.max_slots)
        return emitted

    def _guarded_decode(self, tokens, active: List[int]):
        """Legacy decode dispatch: ``decode_step`` advances every row, so the
        rows of inactive slots (half-prefilled neighbours included) are
        copied before and restored after -- bit-for-bit untouched."""
        idle = [i for i in range(self.max_slots) if i not in set(active)]
        saved = None
        if idle:
            ix = self._t(idle, torch.long)
            saved = (ix, self.cache["k"][:, ix].clone(),
                     self.cache["v"][:, ix].clone(),
                     self.cache["seq_lens"][ix].clone())
        _, logits = self.model.decode_step(self.params, tokens, self.cache)
        if saved is not None:
            ix, k, v, sl = saved
            self.cache["k"][:, ix] = k
            self.cache["v"][:, ix] = v
            self.cache["seq_lens"][ix] = sl
        return logits

    def serve_step(self) -> Dict[int, int]:
        """One scheduler tick. Mixed mode (the default): every queued
        prefill job consumes a chunk AND every decoding slot advances one
        token in a single model dispatch. Legacy mode: one chunk dispatch if
        work is queued, then one guarded decode dispatch. Returns {slot:
        token appended this tick}."""
        if not self.mixed:
            if self.prefill_pending():
                self.prefill_step()
            return self.step()
        with self._lock:
            jobs = list(self._prefill_queue)
        if not jobs:
            return self.step()
        return self._mixed_dispatch(jobs)

    def _mixed_dispatch(self, jobs: List[_PendingPrefill],
                        decode=None) -> Dict[int, int]:
        """The unified dispatch: prefill rows (one chunk each), decode rows
        (length-1 chunks at their current position) and untouched rows
        (length 0) in ONE model call. ``decode`` is the set of slots that
        advance one token -- None means every active slot (the serve tick);
        ``prefill_step`` passes (). A small burst on a mostly idle engine is
        gathered into a power-of-two batch bucket (its rows' live
        ``[:kv]`` cache), run, and scattered back."""
        active = self.active_slots() if decode is None else list(decode)
        if not jobs and not active:
            return {}
        _t0 = self._obs_t0()
        _t_build = _t0
        _kind = KIND_PADDED
        if jobs:
            rem = max(len(j.tokens) - j.done for j in jobs)
            C = next((b for b in self.prefill_chunks if b >= rem),
                     self.prefill_chunks[-1])
        else:
            C = 1
        part = [j.slot for j in jobs] + active
        kb = 1
        while kb < len(part):
            kb *= 2
        if kb >= self.max_slots:
            kb = self.max_slots
            idx = None                      # full batch: row == slot
            row_of = {s: s for s in part}
        else:
            idx = list(part)
            taken = set(idx)
            idx += [i for i in range(self.max_slots) if i not in taken][
                :kb - len(idx)]
            row_of = {s: r for r, s in enumerate(part)}
        buf = np.zeros((kb, C), np.int32)
        lengths = np.zeros((kb,), np.int32)
        offsets = np.zeros((kb,), np.int32)
        job_rows = []
        for j in jobs:
            r = row_of[j.slot]
            n = min(len(j.tokens) - j.done, C)
            buf[r, :n] = j.tokens[j.done:j.done + n]
            lengths[r] = n
            offsets[r] = j.done
            job_rows.append((r, j, n))
        if active:          # pure-prefill dispatches never sync the device
            pend_host = self.next_tokens.tolist()
        for slot in active:
            r = row_of[slot]
            s = self.slots[slot]
            buf[r, 0] = pend_host[slot]
            lengths[r] = 1
            offsets[r] = len(s.prompt) + len(s.generated)
        max_end = min(self.max_len, int((offsets + lengths).max()))
        kv = next(b for b in self.kv_buckets if b >= max_end)
        if idx is None:
            piece = self.cache
        else:
            ix = self._t(idx, torch.long)
            piece = {"k": self.cache["k"][:, ix, :kv],
                     "v": self.cache["v"][:, ix, :kv],
                     "seq_lens": self.cache["seq_lens"][ix]}
        # token-packed ragged dispatch when the real tokens fit a packed
        # bucket smaller than the [kb, C] rectangle: a decode row costs 1
        # token, a 7-token tail chunk 7, not C
        row_starts = np.zeros((kb,), np.int32)
        row_starts[1:] = np.cumsum(lengths)[:-1]
        cur = int(lengths.sum())
        Npb = next((b for b in PACKED_BUCKETS if b >= max(cur, 1)), None)
        use_packed = self.packed and Npb is not None and Npb < kb * C
        if _t0:
            _t_build = time.perf_counter()
        if use_packed:
            _kind = KIND_PACKED
            flat = np.zeros((Npb,), np.int32)
            for r in range(kb):
                n = int(lengths[r])
                if n:
                    flat[row_starts[r]:row_starts[r] + n] = buf[r, :n]
            _, logits = self.model.prefill_packed(
                self.params, self._t(flat), piece,
                row_starts=self._t(row_starts), q_offset=self._t(offsets),
                lengths=self._t(lengths), chunk=C, kv_width=kv)
            self.stats["packed_dispatches"] += 1
            self.stats["packed_tokens"] += int(lengths.sum())
            self.stats["packed_padded_tokens"] += kb * C
        else:
            _, logits = self.model.prefill_chunk(
                self.params, self._t(buf), piece, q_offset=self._t(offsets),
                lengths=self._t(lengths), kv_width=kv)
        if idx is not None:
            self.cache["k"][:, ix, :kv] = piece["k"]
            self.cache["v"][:, ix, :kv] = piece["v"]
            self.cache["seq_lens"][ix] = piece["seq_lens"]
        self.stats["model_dispatches"] += 1
        if self.mixed:
            self.stats["mixed_steps"] += 1
        fin = []
        for r, j, n in job_rows:
            j.done += n
            if j.done >= len(j.tokens):
                fin.append((r, j))
        if jobs:
            self.stats["prefill_chunks"] += 1
            self.stats["batched_prefill_tokens"] += int(
                sum(n for _, _, n in job_rows))
        # one sampling pass for finishing-prefill rows AND decode rows
        sample_rows = [r for r, _ in fin] + [row_of[s] for s in active]
        sample_slots = [j.slot for _, j in fin] + active
        emitted: Dict[int, int] = {}
        if sample_rows:
            picked = logits[self._t(sample_rows, torch.long)]
            self.next_tokens[self._t(sample_slots, torch.long)] = \
                self._sample(picked, sample_slots)
            for _, j in fin:
                s = self.slots[j.slot]
                s.prefilling = False
                s.counter += 1
            for slot in active:
                s = self.slots[slot]
                t = int(pend_host[slot])
                s.generated.append(t)
                if s.sink is not None:
                    s.sink(t)
                s.counter += 1
                emitted[slot] = t
                self.pager.grow(f"slot{slot}",
                                len(s.prompt) + len(s.generated) + 1)
        if active:
            self.stats["decode_steps"] += 1
            self.stats["tokens"] += len(active)
            self.stats["mixed_decode_rows"] += len(active)
        if fin:
            with self._lock:
                done_set = {j.slot for _, j in fin}
                self._prefill_queue = [jj for jj in self._prefill_queue
                                       if jj.slot not in done_set]
        if _t0:
            self._obs_tick(_kind, _t0, _t_build, len(part), kb, C, kv,
                           int(lengths.sum()), kb * C)
        return emitted

    def is_done(self, slot: int) -> bool:
        s = self.slots[slot]
        if not s.active:
            return True
        if s.prefilling:
            return False
        if len(s.generated) >= s.max_new:
            return True
        return bool(s.generated) and s.generated[-1] == s.eos_id

    def result(self, slot: int) -> List[int]:
        return list(self.slots[slot].generated)

    def free(self, slot: int):
        with self._lock:
            self.slots[slot].active = False
            self.slots[slot].prefilling = False
            self.slots[slot].sink = None
            self._prefill_queue = [j for j in self._prefill_queue
                                   if j.slot != slot]
            self.pager.release(f"slot{slot}")
            self.cache["seq_lens"][slot] = 0

    # -- context switch (paper §3.4) ---------------------------------------------
    def snapshot(self, slot: int, *, kind: str = "logits") -> ContextSnapshot:
        """Suspend a sequence: capture its state and free the slot. The
        logits kind copies the slot's live K/V (positions < seq_len) to the
        host."""
        s = self.slots[slot]
        if not s.active or s.prefilling:
            raise RuntimeError(f"slot {slot} is not decoding; cannot snapshot")
        seq_len = len(s.prompt) + len(s.generated)
        pending = int(self.next_tokens[slot])
        state = None
        if kind == "logits":
            # copies, also on a CPU engine: the slot is reused after free()
            state = [t.to("cpu", copy=True) for t in (
                self.cache["k"][:, slot, :seq_len],
                self.cache["v"][:, slot, :seq_len],
                self.cache["seq_lens"][slot:slot + 1])]
        snap = ContextSnapshot(
            kind=kind, prompt=s.prompt.copy(), generated=list(s.generated),
            seq_len=seq_len, seq_seed=self.seq_seeds[slot], counter=s.counter,
            state=state, pending_token=pending, origin=self.engine_id,
            max_new=s.max_new, eos_id=s.eos_id)
        self.free(slot)
        self.stats["preemptions"] += 1
        return snap

    def restore(self, snap: ContextSnapshot, *, seq_id=None,
                eager: bool = True, sink=None) -> int:
        """Resume a suspended sequence into a free slot (exact continuation).
        A text-kind snapshot re-prefills its context; with ``eager=False``
        that re-prefill only joins the chunked queue."""
        with self._lock:
            slot = self._find_free_slot()
            if slot is None:
                raise RuntimeError("no free decode slot")
            if not self.pager.reserve(f"slot{slot}", snap.seq_len + 1):
                raise RuntimeError("device KV pages exhausted")
            s = self.slots[slot]
            s.active = True
            s.seq_id = seq_id
            s.prompt = snap.prompt
            s.generated = list(snap.generated)
            s.max_new = snap.max_new
            s.eos_id = snap.eos_id
            s.sink = sink     # only tokens generated after the resume flow
            s.prefilled = 0   # the prompt was paid for at first admission
        self.seq_seeds[slot] = snap.seq_seed
        if snap.kind == "logits":
            k, v, sl = snap.state
            n = k.shape[1]
            self.cache["k"][:, slot, :n] = k.to(self.device)
            self.cache["v"][:, slot, :n] = v.to(self.device)
            self.cache["seq_lens"][slot:slot + 1] = sl.to(self.device)
            self.next_tokens[slot] = snap.pending_token
            s.counter = snap.counter
        else:  # text: re-prefill prompt + generated prefix, re-draw pending
            s.counter = snap.counter - 1
            ctx = np.concatenate([snap.prompt,
                                  np.asarray(snap.generated, np.int32)]) \
                if snap.generated else snap.prompt
            if self.serial_prefill:
                self._prefill_into(slot, ctx)
            else:
                self._enqueue_prefill(slot, ctx, done=0, fresh=True)
                while eager and self.slots[slot].prefilling:
                    self.prefill_step()
        self.stats["restores"] += 1
        return slot


__all__ = ["ServingEngine", "ContextSnapshot", "PREFILL_CHUNKS",
           "PACKED_BUCKETS"]
