"""Batched serving engine: slot-table continuous batching with chunked
prefill and admission control.

Port of ``src/repro/serving/engine.py``.  The engine owns a fixed table
of ``batch_size`` slots and advances in **ticks**.  Each tick:

1. **admit** — free slots refill from the request queue immediately
   (continuous batching), bounded by the memory budget: each slot's KV
   cache is priced by :func:`repro_torch.serving.kv_cache.slot_bytes` and
   slots beyond ``budget // slot_bytes`` are never occupied.
2. **prefill** — slots still ingesting their prompt consume up to
   ``prefill_chunk`` prompt tokens each through one ``model.extend`` call,
   bounded globally by ``max_prefill_tokens`` per tick.  A model without
   a native ``extend`` (the SSM and hybrid blocks) takes the reference's
   sequential fallback: the chunk's columns go through ``decode_step`` in
   order, and a slot past its ``valid`` count is frozen by
   :meth:`ServeEngine._select`.  A slot whose prompt completes samples
   its first token from its last valid chunk position and flips to
   decode.
3. **decode** — every decoding slot feeds its last sampled token through
   one ``model.decode_step`` call; EOS or ``max_new_tokens`` frees the
   slot at end of tick.

A MoE model (``olmoe_1b_7b``) takes the native ``extend``: each slot's
chunk is one token group, its padded columns routed too, as in the
reference; they follow the slot's real tokens in the dispatch order, so
they only take capacity that no real token of the chunk asked for.

Slots are right-aligned (every slot's KV history starts at offset 0 and
rope positions are per-slot), so a request's outputs do not depend on
its slot or its neighbours.  Host-side numpy arrays are the authoritative
slot state; the cache's per-slot lengths are set from them before every
call, and inactive slots are frozen out of every call by a per-field
``torch.where`` on the batch axis.

A quantized ``kv_policy`` (fp8_e4m3, fp8_e5m2, int8; attention-only
models) stores the K/V buffers as a
:class:`~repro_torch.serving.kv_cache.QuantKV` and prices a slot at its
storage width: every tick dequantizes the
cache, runs the model step, keeps the active slots' new K/V and
requantizes under the running per-layer amax (``prev=`` the last
tick's).  As in the reference, admission does not zero a quantized
cache: a new slot's stale entries sit past its length, where no mask
exposes them.

Differences from the reference: the tick functions run eagerly (no
``jit``); sampling draws from a ``torch.Generator`` seeded from ``seed``,
so sampled (temperature > 0) streams differ from the reference's while
greedy ones match; the sequential fallback stops
after the chunk's last column that some slot still ingests (the
reference runs all ``prefill_chunk`` columns; the ones skipped are
frozen for every slot, and no caller reads their logits).  With
tracing on, the ``serve.prefill_chunk`` and
``serve.decode_step`` spans wait for the card before they close, so on a
GPU they hold the tick's device time, not its launch time; tracing off,
the engine never synchronizes inside a tick.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch import telemetry as tm
from repro_torch.memory.planner import parse_budget
from repro_torch.precision.policy import QuantPolicy
from repro_torch.serving import kv_cache as kvq

FREE, PREFILL, DECODE = 0, 1, 2


def _end_on_device(out: torch.Tensor) -> None:
    """Tracing on and ``out`` on a GPU: wait for the card, so the
    enclosing tick span closes when the tick's kernels have run."""
    if tm.enabled() and out.is_cuda:
        torch.cuda.synchronize(out.device)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [T] int32
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 = greedy
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float | None = None   # wall-clock hooks for benchmarks
    t_admit: float | None = None
    t_first: float | None = None
    t_done: float | None = None

    @property
    def ttft_s(self) -> float | None:
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit


def _tree_map(fn, *trees):
    """``fn`` over the tensors of nested tuples (cache NamedTuples);
    ``None`` fields stay ``None``."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(_tree_map(fn, *parts)
                             for parts in zip(*trees)))
    return fn(*trees)


class ServeEngine:
    def __init__(self, model, *, batch_size: int, max_len: int,
                 eos_id: int | None = None, seed: int = 0,
                 prefill_chunk: int = 32,
                 max_prefill_tokens: int | None = None,
                 kv_policy: QuantPolicy | str | None = None,
                 memory_budget: int | str | None = None):
        self.model = model
        self.batch = batch_size
        self.max_len = max_len
        self.eos_id = eos_id
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if max_prefill_tokens is not None and max_prefill_tokens < 1:
            raise ValueError("max_prefill_tokens must be >= 1")
        self.prefill_chunk = prefill_chunk
        self.max_prefill_tokens = max_prefill_tokens
        self.queue: deque[Request] = deque()
        self.device = torch.device(getattr(model, "device", "cpu"))
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

        if isinstance(kv_policy, str):
            kv_policy = QuantPolicy.parse(kv_policy)
        if kv_policy is not None and not kv_policy.quantized:
            kv_policy = None
        self.kv_policy = kv_policy
        cfg = getattr(model, "cfg", None)
        self._kv_dtype = getattr(cfg, "compute_dtype", torch.bfloat16)
        attn_only = cfg is None or (getattr(cfg, "block", "attn") == "attn"
                                    and not getattr(cfg, "hybrid", None))
        self._native_extend = attn_only and hasattr(model, "extend")
        if kv_policy is not None and not attn_only:
            raise ValueError("quantized KV requires an attention-only model")

        # -- admission capacity: memory budget / modeled per-slot bytes ----
        if cfg is not None and attn_only:
            self.slot_cost = kvq.slot_bytes(cfg, max_len, kv_policy)
        elif cfg is not None:
            per = kvq.model_slot_bytes(model, max_len)
            self.slot_cost = {"payload": per, "meta": 0, "total": per}
        else:
            self.slot_cost = {"payload": 0, "meta": 0, "total": 0}
        budget = parse_budget(memory_budget)
        self.memory_budget = budget
        if budget is None:
            self.capacity = batch_size
        else:
            self.capacity = min(batch_size,
                                budget // max(self.slot_cost["total"], 1))
            if self.capacity == 0:
                raise ValueError(
                    f"memory budget {budget} bytes cannot hold one slot "
                    f"({self.slot_cost['total']} bytes at max_len={max_len})")

        # -- slot table (host-authoritative) --------------------------------
        B = batch_size
        self.slot_req: list[Request | None] = [None] * B
        self.phase = np.full(B, FREE, np.int32)
        self.lengths = np.zeros(B, np.int32)        # KV tokens written
        self.prefill_pos = np.zeros(B, np.int32)    # prompt tokens consumed
        self.next_tok = np.zeros(B, np.int32)       # last sampled token
        self._admit_seq = np.zeros(B, np.int64)     # admission order
        self._seq = 0
        self.tick = 0
        self.events: list[tuple[int, str, int]] = []
        self.max_occupancy = 0
        self.completed: list[Request] = []

        # prefill writes a full chunk of (masked) positions starting at a
        # slot's current length, so the buffer carries chunk-width slack.
        self.cache_len = max_len + prefill_chunk
        self._init_device_cache()

    # -- device cache -------------------------------------------------------

    def _init_device_cache(self):
        cache = self.model.init_cache(self.batch, self.cache_len)
        if self.kv_policy is None:
            self.cache = cache._replace(length=torch.zeros(
                self.batch, dtype=torch.int32))
            self.qkv = None
        else:
            self._cache_type = type(cache)
            self.cache = None
            self.qkv = kvq.quantize_kv(cache.k, cache.v, self.kv_policy)

    def _cache_in(self):
        """The cache the model reads this tick, at the host table's
        per-slot lengths: the stored one, or the quantized one
        dequantized to the compute dtype."""
        lengths = torch.from_numpy(self.lengths)
        if self.kv_policy is None:
            return self.cache._replace(length=lengths)
        k, v = kvq.dequantize_kv(self.qkv, self.kv_policy, self._kv_dtype)
        return self._cache_type(k, v, lengths)

    def _commit(self, active: np.ndarray, new, cache) -> None:
        """Keep ``new`` for the active slots and ``cache`` for the rest; a
        quantized cache is requantized under its running amax."""
        new = self._select(active, new, cache)
        if self.kv_policy is None:
            self.cache = new
        else:
            self.qkv = kvq.quantize_kv(new.k, new.v, self.kv_policy,
                                       prev=self.qkv)

    def _select(self, active: np.ndarray, new, old):
        """Per-tensor batch-axis select over the (nested) cache:
        inactive slots keep their old state.  Stacked per-layer buffers
        are >= 3-D with batch on axis 1 ([L, B, ...]), per-slot vectors
        1-/2-D with batch on axis 0 — checked in that order.  Tensors
        without a batch axis pass through from ``new``."""
        B = self.batch

        def sel(n, o):
            if n.dim() >= 3 and n.shape[1] == B:
                shape = (1, B) + (1,) * (n.dim() - 2)
            elif n.dim() >= 1 and n.shape[0] == B:
                shape = (B,) + (1,) * (n.dim() - 1)
            else:
                return n
            m = torch.as_tensor(active, device=n.device).reshape(shape)
            return torch.where(m, n, o)

        return _tree_map(sel, new, old)

    @torch.no_grad()
    def _extend(self, toks: np.ndarray, valid: np.ndarray,
                active: np.ndarray) -> torch.Tensor:
        cache = self._cache_in()
        if self._native_extend:
            logits, new = self.model.extend(
                torch.as_tensor(toks, device=self.device), cache,
                valid=torch.from_numpy(valid))
        else:
            logits, new = self._extend_sequential(toks, valid, cache)
        self._commit(active, new, cache)
        return logits

    def _extend_sequential(self, toks: np.ndarray, valid: np.ndarray,
                           cache):
        """The reference's fallback for a model without ``extend``: the
        chunk's columns through ``decode_step`` in order, each slot
        frozen past its ``valid`` count.  Returns the columns' logits
        ``[B, n, V]`` (``n`` the largest ``valid``, at least 1) and the
        cache."""
        logits = []
        for i in range(max(int(valid.max()), 1)):
            out, new = self.model.decode_step(
                torch.as_tensor(toks[:, i], device=self.device), cache)
            cache = self._select(valid > i, new, cache)
            logits.append(out)
        return torch.stack(logits, dim=1), cache

    @torch.no_grad()
    def _decode(self, active: np.ndarray) -> torch.Tensor:
        cache = self._cache_in()
        logits, new = self.model.decode_step(
            torch.as_tensor(self.next_tok, device=self.device), cache)
        self._commit(active, new, cache)
        return logits

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds "
                f"max_len={self.max_len}")
        if req.t_submit is None:
            req.t_submit = time.monotonic()
        self.queue.append(req)

    @property
    def occupancy(self) -> int:
        return int(np.sum(self.phase != FREE))

    @property
    def busy(self) -> bool:
        return bool(self.queue) or self.occupancy > 0

    def warmup(self) -> None:
        """Run one prefill and one decode call at full batch width (plans
        searched, kernels built and launched once) outside the serving
        clock, then reset the cache and the sampling stream."""
        with tm.span("serve.warmup"):
            B, C = self.batch, self.prefill_chunk
            state = self.gen.get_state()
            zeros = np.zeros(B, np.int32)
            idle = np.zeros(B, bool)
            logits = self._extend(np.zeros((B, C), np.int32), zeros, idle)
            self._sample(logits[:, 0], np.zeros(B, np.float32))
            dlogits = self._decode(idle)
            self._sample(dlogits, np.zeros(B, np.float32))
            self.gen.set_state(state)
            self._init_device_cache()

    # -- tick phases --------------------------------------------------------

    def _admit(self) -> list[int]:
        admitted = []
        for slot in range(self.batch):
            if not self.queue:
                break
            if self.phase[slot] != FREE or self.occupancy >= self.capacity:
                continue
            req = self.queue.popleft()
            req.t_admit = time.monotonic()
            self.slot_req[slot] = req
            self.phase[slot] = PREFILL
            self.lengths[slot] = 0
            self.prefill_pos[slot] = 0
            self._admit_seq[slot] = self._seq
            self._seq += 1
            self.events.append((self.tick, "admit", req.rid))
            admitted.append(slot)
        if admitted and self.kv_policy is None:
            mask = np.zeros(self.batch, bool)
            mask[admitted] = True
            zeros = _tree_map(torch.zeros_like, self.cache)
            self.cache = self._select(mask, zeros, self.cache)
        if admitted:
            tm.inc("serve.admitted", len(admitted))
        self.max_occupancy = max(self.max_occupancy, self.occupancy)
        tm.sample("serve.occupancy", self.occupancy)
        return admitted

    def _sample(self, logits: torch.Tensor, temps: np.ndarray) -> np.ndarray:
        lf = logits.float()
        pick = torch.argmax(lf, dim=-1)
        if (temps > 0).any():
            t = torch.as_tensor(np.maximum(temps, 1e-4), device=lf.device)
            probs = torch.softmax(lf / t[:, None], dim=-1)
            temped = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
            hot = torch.as_tensor(temps > 0, device=lf.device)
            pick = torch.where(hot, temped, pick)
        return pick.cpu().numpy().astype(np.int32)

    def _append_token(self, slot: int, tok: int) -> None:
        """Record a sampled token; finish the request when EOS or the
        budget lands (EOS honored on every token including the first)."""
        req = self.slot_req[slot]
        req.out_tokens.append(tok)
        if req.t_first is None:
            req.t_first = time.monotonic()
        self.next_tok[slot] = tok
        if ((self.eos_id is not None and tok == self.eos_id)
                or len(req.out_tokens) >= req.max_new_tokens):
            self._finish(slot)
        else:
            self.phase[slot] = DECODE

    def _finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        req.done = True
        req.t_done = time.monotonic()
        self.completed.append(req)
        self.events.append((self.tick, "finish", req.rid))
        if tm.enabled():
            tm.inc("serve.completed")
            tm.event("serve.request_done", rid=req.rid,
                     tokens=len(req.out_tokens), ttft_s=req.ttft_s,
                     total_s=req.t_done - req.t_submit)
        self.slot_req[slot] = None
        self.phase[slot] = FREE

    def _prefill_tick(self) -> None:
        B, C = self.batch, self.prefill_chunk
        budget = self.max_prefill_tokens or B * C
        valid = np.zeros(B, np.int32)
        toks = np.zeros((B, C), np.int32)
        slots = [s for s in range(B) if self.phase[s] == PREFILL]
        # token budget distributes in admission order (oldest first)
        for slot in sorted(slots, key=lambda s: self._admit_seq[s]):
            if budget <= 0:
                break
            req = self.slot_req[slot]
            pos = int(self.prefill_pos[slot])
            take = min(C, len(req.prompt) - pos, budget)
            if take <= 0:
                continue
            toks[slot, :take] = req.prompt[pos:pos + take]
            valid[slot] = take
            budget -= take
        if not valid.any():
            return
        active = valid > 0
        tm.inc("serve.prefill_tokens", int(valid.sum()))
        with tm.span("serve.prefill_chunk", tick=self.tick,
                     tokens=int(valid.sum()), slots=int(active.sum())):
            logits = self._extend(toks, valid, active)
            _end_on_device(logits)
        self.lengths[active] += valid[active]
        self.prefill_pos[active] += valid[active]

        finishing = [s for s in np.nonzero(active)[0]
                     if self.prefill_pos[s] >= len(self.slot_req[s].prompt)]
        if finishing:
            cols = torch.as_tensor(np.maximum(valid - 1, 0),
                                   device=logits.device).long()
            last = logits[torch.arange(B, device=logits.device), cols]
            temps = np.zeros(B, np.float32)
            for s in finishing:
                temps[s] = self.slot_req[s].temperature
            picks = self._sample(last, temps)
            for s in finishing:
                self._append_token(int(s), int(picks[s]))

    def _decode_tick(self) -> None:
        active = self.phase == DECODE
        if not active.any():
            return
        tm.inc("serve.decode_tokens", int(active.sum()))
        with tm.span("serve.decode_step", tick=self.tick,
                     slots=int(active.sum())):
            logits = self._decode(active)
            _end_on_device(logits)
        self.lengths[active] += 1
        temps = np.array([self.slot_req[s].temperature if active[s] else 0.0
                          for s in range(self.batch)], np.float32)
        picks = self._sample(logits, temps)
        for slot in np.nonzero(active)[0]:
            self._append_token(int(slot), int(picks[slot]))

    # -- main loop ----------------------------------------------------------

    def step(self) -> list[Request]:
        """One tick: admit, prefill chunk, decode.  Returns the requests
        that completed during the tick."""
        before = len(self.completed)
        self._admit()
        self._prefill_tick()
        self._decode_tick()
        self.tick += 1
        return self.completed[before:]

    @torch.inference_mode()
    def run(self, max_ticks: int | None = None) -> list[Request]:
        """Drain the queue; returns all completed requests."""
        limit = max_ticks if max_ticks is not None else 10_000_000
        while self.busy:
            if limit <= 0:
                raise RuntimeError("ServeEngine.run(): tick limit exceeded")
            self.step()
            limit -= 1
        return self.completed
