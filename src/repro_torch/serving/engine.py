"""The continuous-batching engine: one step over slot-indexed state.

Port of ``repro.serving.engine``. Each call of the engine step (a) admits
up to ``A`` newly arrived requests into free slots through a cumsum pack
over the free-slot mask, on the device, (b) prefills the admitted rows (a
batched padded prefill whose cache rows are merged only for taken slots,
skipped on ticks with no arrivals), and (c) decodes ``decode_chunk``
tokens for every active slot (slot-indexed KV writes, per-slot
positions, active masking, on-device sampling).

All shapes are fixed - (N) slots, (A, P) arrival buffers, a fixed chunk -
so every tick runs the same operations on the same shapes. The reference
counts its compiled traces (``step.trace_count``); eager PyTorch compiles
nothing, so the port's step has no counterpart.

The reference skips the prefill with ``lax.cond`` on ``take.any()``, read
on the device. Here the host decides from what it already knows: the
prefill runs when ``n_arr > 0`` and the caller's free-slot count (when
given) is not 0, so no tick waits on a device read to decide.

Invariant the bit-identity leans on: KV caches only ever hold FINITE
values. Freed slots are not zeroed - their stale rows are masked out of
attention by the per-row causal mask, and a masked FINITE value is a
bitwise no-op on the softmax (exact-zero weight), whereas a NaN/Inf would
poison the row max (hence ``init_caches`` fills zeros). Stale rows in the
new request's decode region are overwritten the tick before they could
first be attended.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.serving.batching import _last_logits, _row_sample
from repro_torch.serving.runners import cache_where

Tensor = torch.Tensor


class EngineState(NamedTuple):
    caches: object          # runner cache tree, slot axis = num_slots
    prompt: Tensor          # (N, P) zero-padded admitted prompts
    plen: Tensor            # (N,) true prompt lengths
    gen_target: Tensor      # (N,) tokens wanted per slot
    pos: Tensor             # (N,) per-slot KV entry count
    last_tok: Tensor        # (N,) token feeding the next decode
    n_gen: Tensor           # (N,) tokens generated so far
    active: Tensor          # (N,) bool slot is mid-request
    req_id: Tensor          # (N,) request id (-1 = never used)
    gen_buf: Tensor         # (N, G) generated tokens per slot
    busy_steps: Tensor      # () f32: sum of active slots per decode step
    decode_steps: Tensor    # () f32: decode steps run


def init_engine_state(runner, num_slots: int, prompt_pad: int,
                      max_new: int, cache_len: Optional[int] = None
                      ) -> EngineState:
    """Empty slots on the runner's device; zero-filled caches of
    ``cache_len`` (``prompt_pad + max_new`` by default) entries."""
    n, p, g = num_slots, prompt_pad, max_new
    dev = runner.device
    if cache_len is None:
        cache_len = p + g

    def z(*shape, dtype=torch.long):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return EngineState(
        caches=runner.init_caches(n, cache_len),
        prompt=z(n, p), plen=torch.ones((n,), dtype=torch.long, device=dev),
        gen_target=z(n), pos=z(n), last_tok=z(n), n_gen=z(n),
        active=z(n, dtype=torch.bool),
        req_id=torch.full((n,), -1, dtype=torch.long, device=dev),
        gen_buf=z(n, g), busy_steps=z(dtype=torch.float32),
        decode_steps=z(dtype=torch.float32))


def evict_slots(state: EngineState, mask) -> EngineState:
    """Free the masked slots WITHOUT touching their caches.

    For a host that must hand in-flight requests back to the queue (a
    stage's device died). Caches are left stale on purpose: the
    finite-garbage invariant (module docstring) makes masked stale rows a
    bitwise no-op, exactly as after a normal completion, so eviction
    cannot change the tokens of requests it never touched."""
    mask = torch.as_tensor(np.asarray(mask) if not torch.is_tensor(mask) else mask,
                           device=state.active.device).to(torch.bool)
    return state._replace(
        active=state.active & ~mask,
        req_id=torch.where(mask, torch.full_like(state.req_id, -1), state.req_id),
        n_gen=torch.where(mask, torch.zeros_like(state.n_gen), state.n_gen),
    )


def make_engine_step(runner, *, num_slots: int, arrival_slots: int,
                     prompt_pad: int, max_new: int, decode_chunk: int = 8,
                     temperature: float = 0.0, base_key: int = 0):
    """Build the engine step.

    ``step(params, state, arr_prompt (A, P), arr_plen (A,), arr_gen (A,),
    arr_req (A,), n_arr, free_slots=None)`` -> ``(state, report)``, where
    ``report`` is ``{active, req_id, n_gen, admitted}`` on the device.
    ``n_arr`` is a host int; the arrival arrays may be numpy or tensors.
    ``base_key`` is the sampling seed (an int, where the reference takes
    a PRNG key).

    The prefill runs only when ``n_arr > 0`` and ``free_slots`` (the
    caller's count of free slots, when given) is not 0.

    The step runs under ``torch.inference_mode`` (no autograd records, a
    lighter dispatch per operation: the decode chunk is bound by the
    host's launches), so the state it returns holds inference tensors:
    read them and build new ones from them, but do not update them in
    place outside inference mode.
    """
    n, a, g = num_slots, arrival_slots, max_new
    dev = runner.device

    def arr(x):
        x = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x))
        return x.to(device=dev, dtype=torch.long)

    def step(params, state: EngineState, arr_prompt, arr_plen, arr_gen,
             arr_req, n_arr, free_slots: Optional[int] = None):
        n_arr = int(n_arr)
        arr_prompt, arr_plen, arr_gen, arr_req = (
            arr(x) for x in (arr_prompt, arr_plen, arr_gen, arr_req))
        with torch.inference_mode():
            # ---- admission: pack arrivals into free slots, on the device
            free = ~state.active
            order = torch.cumsum(free.to(torch.long), 0) - 1  # rank among free
            take = free & (order < n_arr)
            ai = torch.clamp(order, 0, a - 1)  # arrival row of each slot
            prompt = torch.where(take[:, None], arr_prompt[ai], state.prompt)
            plen = torch.where(take, arr_plen[ai], state.plen)
            gen_target = torch.where(take, arr_gen[ai], state.gen_target)
            req_id = torch.where(take, arr_req[ai], state.req_id)
            n_gen = torch.where(take, torch.zeros_like(state.n_gen), state.n_gen)
            gen_buf = torch.where(take[:, None], torch.zeros_like(state.gen_buf),
                                  state.gen_buf)
            active = state.active | take

            # ---- prefill (only the taken rows land) ----------------------
            caches, last_tok, pos = state.caches, state.last_tok, state.pos
            if n_arr > 0 and free_slots != 0:
                logits_all, new_caches = runner.prefill(params, caches, prompt)
                caches = cache_where(take, new_caches, caches)
                last = _last_logits(logits_all, plen)
                del logits_all, new_caches
                tok0 = _row_sample(last.float(), base_key, req_id,
                                   torch.zeros((n,), dtype=torch.long, device=dev),
                                   temperature)
                last_tok = torch.where(take, tok0, last_tok)
                pos = torch.where(take, plen, pos)
            first = gen_buf.clone()
            first[:, 0] = last_tok
            gen_buf = torch.where(take[:, None], first, gen_buf)
            n_gen = torch.where(take, torch.ones_like(n_gen), n_gen)
            # a gen_target == 1 request completes at admission
            active = active & (n_gen < torch.clamp(gen_target, min=1))

            # ---- decode chunk: every slot at its own position ------------
            busy = state.busy_steps
            for _ in range(decode_chunk):
                busy = busy + active.sum().to(torch.float32)
                logits, caches = runner.decode(params, last_tok[:, None],
                                               caches, pos)
                nxt = _row_sample(logits.float(), base_key, req_id, n_gen,
                                  temperature)
                last_tok = torch.where(active, nxt, last_tok)
                col = torch.clamp(n_gen, 0, g - 1)[:, None]
                written = gen_buf.scatter(1, col, last_tok[:, None])
                gen_buf = torch.where(active[:, None], written, gen_buf)
                pos = torch.where(active, pos + 1, pos)
                n_gen = torch.where(active, n_gen + 1, n_gen)
                active = active & (n_gen < gen_target)

        state = EngineState(
            caches=caches, prompt=prompt, plen=plen, gen_target=gen_target,
            pos=pos, last_tok=last_tok, n_gen=n_gen, active=active,
            req_id=req_id, gen_buf=gen_buf, busy_steps=busy,
            decode_steps=state.decode_steps + decode_chunk)
        report = {"active": active, "req_id": req_id, "n_gen": n_gen,
                  "admitted": take}
        return state, report

    return step
