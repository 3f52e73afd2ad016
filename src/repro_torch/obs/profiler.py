"""Per-tick engine profiler: preallocated ring buffers, zero per-token cost.
(A copy of ``repro/obs/profiler.py``; the port's engine records its ticks
here.)

``ServingEngine.serve_step`` (and the legacy ``step``) record one sample
per model dispatch: the dispatch kind (packed / padded ragged prefill,
pure decode, image batch, serial baseline), the bucket shape that was
actually compiled (batch bucket x chunk x kv bucket), row occupancy, the
packed-vs-padded token saving, and host wall time split at the dispatch
boundary (build = batch assembly before the model call; wall = the whole
tick, which with asynchronous device execution includes device time only
when the tick itself synced -- the engine syncs on the *next* tick's read
of the pending tokens, so successive wall times are still an honest
steady-state tick cost without the profiler adding a single sync).

Everything is written into fixed numpy arrays indexed ``n % cap`` --
``record`` performs scalar stores only (no allocation, no locks on the
write side; each engine is owned by one worker thread). ``summary()``
sorts a copy and serves p50/p90 per kind -- the tick histograms the
registry exports.
"""
from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np

# dispatch kinds (int-coded so `record` stores a scalar, not a string)
KIND_DECODE = 0     # pure decode tick (mixed or legacy decode program)
KIND_PACKED = 1     # mixed tick on the packed [total_tokens] axis
KIND_PADDED = 2     # mixed tick on the padded [kb, C] rectangle
KIND_IMAGE = 3      # mixed tick with image rows (always padded)
KIND_SERIAL = 4     # serial one-sequence prefill (legacy baseline)
KIND_SPEC = 5       # mixed tick carrying speculative draft rows

KIND_NAMES = ("decode", "packed", "padded", "image", "serial", "spec")


class TickProfiler:
    def __init__(self, cap: int = 4096, clock=time.perf_counter):
        self.cap = int(cap)
        self.clock = clock
        self.n = 0                      # ticks recorded (lifetime)
        c = self.cap
        self._kind = np.zeros(c, np.int8)
        self._wall = np.zeros(c, np.float64)    # whole tick, seconds
        self._build = np.zeros(c, np.float64)   # host batch assembly, seconds
        self._rows = np.zeros(c, np.int32)      # participating rows
        self._kb = np.zeros(c, np.int32)        # batch bucket
        self._chunk = np.zeros(c, np.int32)     # chunk width C
        self._kv = np.zeros(c, np.int32)        # kv bucket
        self._tokens = np.zeros(c, np.int32)    # real tokens this tick
        self._padded = np.zeros(c, np.int32)    # padded-rectangle tokens

    def record(self, kind: int, wall: float, build: float, rows: int,
               kb: int, chunk: int, kv: int, tokens: int,
               padded: int) -> None:
        i = self.n % self.cap
        self._kind[i] = kind
        self._wall[i] = wall
        self._build[i] = build
        self._rows[i] = rows
        self._kb[i] = kb
        self._chunk[i] = chunk
        self._kv[i] = kv
        self._tokens[i] = tokens
        self._padded[i] = padded
        self.n += 1

    # -- aggregation ---------------------------------------------------------------
    def _valid(self) -> slice:
        return slice(0, min(self.n, self.cap))

    def summary(self) -> Dict[str, Any]:
        """p50/p90 tick wall time and shape/occupancy aggregates, overall
        and per dispatch kind (the ``kinds`` sub-dict flattens to
        ``kind=...`` labels in the registry)."""
        v = self._valid()
        n = v.stop
        out: Dict[str, Any] = {"ticks": int(self.n), "window": int(n)}
        if n == 0:
            out["kinds"] = {}
            return out
        kind = self._kind[v]
        wall = self._wall[v]
        out["p50_tick_ms"] = float(np.percentile(wall, 50) * 1e3)
        out["p90_tick_ms"] = float(np.percentile(wall, 90) * 1e3)
        kinds: Dict[str, Any] = {}
        for k, name in enumerate(KIND_NAMES):
            sel = kind == k
            m = int(sel.sum())
            if m == 0:
                continue
            w = wall[sel]
            padded = self._padded[v][sel]
            tokens = self._tokens[v][sel]
            kb = self._kb[v][sel]
            kinds[name] = {
                "ticks": m,
                "p50_tick_ms": float(np.percentile(w, 50) * 1e3),
                "p90_tick_ms": float(np.percentile(w, 90) * 1e3),
                "mean_build_ms": float(self._build[v][sel].mean() * 1e3),
                "mean_rows": float(self._rows[v][sel].mean()),
                "mean_batch_bucket": float(kb.mean()),
                "mean_chunk": float(self._chunk[v][sel].mean()),
                "mean_kv_bucket": float(self._kv[v][sel].mean()),
                "mean_occupancy": float(
                    (tokens / np.maximum(padded, 1)).mean()),
                "tokens": int(tokens.sum()),
                "padded_tokens": int(padded.sum()),
            }
            if int(padded.sum()) > 0:
                kinds[name]["token_savings"] = float(
                    1.0 - tokens.sum() / padded.sum())
        out["kinds"] = kinds
        return out
