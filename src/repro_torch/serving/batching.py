"""Static batched generation: a padded prefill, then the decode loop.

Port of ``repro.serving.batching``. The same routine serves as the
launcher's static generate, the static-batch baseline, and the engine's
bit-identity reference (:func:`generate_reference`).

Bit-identity mechanics: per-ROW results at a FIXED batch shape are
invariant to the other rows' contents, but a (1, d) x (d, e) product is
not bitwise a row of the (N, d) x (d, e) one (the libraries pick another
algorithm and another order of accumulation). :func:`generate_reference`
therefore runs the single request alone in row 0 of a batch PADDED to
the engine's slot count: every op has the engine step's shape, so the
equality is structural. There is no ``b == 1`` special case anywhere on
the path.

Sampling. The reference draws from threefry keys folded per request and
per token (``fold_in``), which torch cannot replay. Here the draw is
counter-based instead: the Gumbel noise of row ``b`` for vocabulary entry
``v`` is a pure function of ``(seed, req_id[b], token_idx[b], v)``,
through a splitmix64 integer hash in int64 tensor ops (:func:`_uniform`).
It keeps the property the engine rests on: the draw depends only on
which request and which token, never on the slot or the tick, so the
engine and the reference consume the same draws. There is no generator
state across ticks, and the integer draws are the same on the CPU and on
the card. Greedy (``temperature == 0``) is ``argmax``, the first index on
ties, as ``jnp.argmax``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor

_MASK64 = (1 << 64) - 1


def _i64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    c &= _MASK64
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)


def _shr(z: Tensor, k: int) -> Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def _mix(z: Tensor) -> Tensor:
    """splitmix64's finalizer over int64 tensors (products wrap mod 2^64)."""
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


def _uniform(seed: int, req_id: Tensor, token_idx: Tensor, vocab: int) -> Tensor:
    """(B, V) f32 uniforms in (0, 1), entry ``[b, v]`` a pure function of
    ``(seed, req_id[b], token_idx[b], v)``: the row key is the hash of the
    three, and entry ``v`` is the ``v``-th output of splitmix64 from it;
    the top 24 bits make the float."""
    dev = req_id.device
    key = _mix(torch.full_like(req_id, _i64(seed), dtype=torch.int64) + _GOLDEN)
    key = _mix(key ^ req_id.to(torch.int64))
    key = _mix(key ^ token_idx.to(torch.int64))
    ctr = torch.arange(1, vocab + 1, dtype=torch.int64, device=dev) * _GOLDEN
    bits = _shr(_mix(key[:, None] + ctr[None, :]), 40)
    return (bits.to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _gumbel(seed: int, req_id: Tensor, token_idx: Tensor, vocab: int) -> Tensor:
    return -torch.log(-torch.log(_uniform(seed, req_id, token_idx, vocab)))


def _row_sample(logits: Tensor, base_key: int, req_id: Tensor, token_idx,
                temperature: float) -> Tensor:
    """Per-row sampling, (B, V) logits -> (B,) tokens: row ``b`` draws
    with the counter ``(base_key, req_id[b], token_idx[b])`` (see the
    module docstring), ``argmax(logits / T + gumbel)``; ``T == 0`` is the
    plain argmax."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    token_idx = torch.as_tensor(token_idx, device=logits.device).expand(req_id.shape)
    g = _gumbel(int(base_key), req_id, token_idx, logits.shape[-1])
    return torch.argmax(logits.float() / temperature + g, dim=-1)


def sample_token(logits: Tensor, key: int, temperature: float) -> Tensor:
    """(..., V) logits -> token(s). ``temperature`` 0.0 is greedy argmax;
    otherwise row ``b`` of a (B, V) batch draws with counter ``(key, b,
    0)`` and a single (V,) row with ``(key, 0, 0)``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    rows = logits.reshape(-1, logits.shape[-1])
    ids = torch.arange(rows.shape[0], device=logits.device)
    tok = _row_sample(rows, key, ids, 0, temperature)
    return tok.reshape(logits.shape[:-1])


def _last_logits(logits_all: Tensor, plens: Tensor) -> Tensor:
    """Row ``b``'s logits at its own last prompt position ``plens[b] - 1``."""
    rows = torch.arange(logits_all.shape[0], device=logits_all.device)
    return logits_all[rows, plens - 1]


def make_generate_fn(runner, *, max_new: int, temperature: float = 0.0):
    """The static generate: ONE prefill, then a decode loop.

    Returned ``generate(params, caches, prompts, plens, gen_targets,
    req_ids, base_key, steps=None)``:

    * ``prompts`` (B, P) zero-padded, ``plens`` (B,) true lengths;
    * ``gen_targets`` (B,) tokens wanted per row (<= max_new); rows stop
      advancing once done (their KV writes freeze in place, masked);
    * ``steps`` decode steps to run, ``max_new - 1`` by default as the
      reference's scan; fewer is the same result when every row is done
      by then (the caller knows ``gen_targets`` on the host);
    * returns ``(tokens (B, max_new), n_gen (B,))``.
    """

    def generate(params, caches, prompts, plens, gen_targets, req_ids,
                 base_key, steps: Optional[int] = None):
        b = prompts.shape[0]
        dev = prompts.device
        logits_all, caches = runner.prefill(params, caches, prompts)
        last = _last_logits(logits_all, plens)
        tok = _row_sample(last.float(), base_key, req_ids,
                          torch.zeros((b,), dtype=torch.long, device=dev),
                          temperature)
        buf = torch.zeros((b, max_new), dtype=torch.long, device=dev)
        buf[:, 0] = tok
        active = gen_targets > 1
        pos = plens.clone()
        n_gen = torch.ones((b,), dtype=torch.long, device=dev)
        for _ in range(max_new - 1 if steps is None else steps):
            logits, caches = runner.decode(params, tok[:, None], caches, pos)
            nxt = _row_sample(logits.float(), base_key, req_ids, n_gen,
                              temperature)
            tok = torch.where(active, nxt, tok)
            col = torch.clamp(n_gen, 0, max_new - 1)[:, None]
            written = buf.scatter(1, col, tok[:, None])
            buf = torch.where(active[:, None], written, buf)
            pos = torch.where(active, pos + 1, pos)
            n_gen = torch.where(active, n_gen + 1, n_gen)
            active = active & (n_gen < gen_targets)
        return buf, n_gen

    return generate


def _long(x, dev) -> Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=dev).to(torch.long)


def generate_static(runner, params, prompts, plens, gen_targets, *,
                    max_new: int, temperature: float = 0.0,
                    base_key: int = 0, req_ids=None, cache_len=None,
                    pad_rows: Optional[int] = None):
    """One-shot static generate (builds the caches, runs).

    ``pad_rows``: pad the batch with inert rows up to this total so the
    decode products have the same shape as an engine with that many
    slots (see the module docstring); returns only the real rows. The
    decode loop stops after ``max(gen_targets) - 1`` steps, when every
    row is done."""
    dev = runner.device
    prompts = _long(prompts, dev)
    plens = _long(plens, dev)
    targets_host = np.asarray(torch.as_tensor(gen_targets).cpu())
    gen_targets = _long(gen_targets, dev)
    b, p = prompts.shape
    req_ids = (torch.arange(b, device=dev) if req_ids is None
               else _long(req_ids, dev))
    n_real = b
    if pad_rows is not None and pad_rows > b:
        pad = pad_rows - b
        z = torch.zeros((pad, p), dtype=torch.long, device=dev)
        one = torch.ones((pad,), dtype=torch.long, device=dev)
        prompts = torch.cat([prompts, z])
        plens = torch.cat([plens, one])
        gen_targets = torch.cat([gen_targets, one])
        req_ids = torch.cat([req_ids, -one])
        b = pad_rows
    if cache_len is None:
        cache_len = p + max_new
    caches = runner.init_caches(b, cache_len)
    gen = make_generate_fn(runner, max_new=max_new, temperature=temperature)
    steps = int(min(max(targets_host.max(initial=1), 1), max_new)) - 1
    with torch.inference_mode():
        buf, n_gen = gen(params, caches, prompts, plens, gen_targets,
                         req_ids, base_key, steps=steps)
    return buf[:n_real], n_gen[:n_real]


def generate_reference(runner, params, prompt, *, gen_target: int,
                       max_new: int, prompt_pad: int, slots: int,
                       temperature: float = 0.0, base_key: int = 0,
                       req_id: int = 0, cache_len=None):
    """THE single-request reference path: one request, alone, in row 0 of
    a ``slots``-row batch (the other rows are inert padding). Engine
    outputs must match this bitwise per request. Returns the tokens as a
    (n,) tensor on the runner's device."""
    prompt = np.asarray(prompt)
    pl = prompt.shape[0]
    padded = np.zeros((1, prompt_pad), np.int64)
    padded[0, :pl] = prompt
    toks, n_gen = generate_static(
        runner, params, padded, [pl], [gen_target], max_new=max_new,
        temperature=temperature, base_key=base_key, req_ids=[req_id],
        cache_len=cache_len, pad_rows=slots)
    return toks[0, :int(n_gen[0])]


def decode_python_loop(runner, params, prompts, plens, gen_targets, *,
                       max_new: int, temperature: float = 0.0,
                       base_key: int = 0, req_ids=None, cache_len=None):
    """The v0 per-token host loop (a host sync per token), kept as the
    benchmark "before" of the reference; gives the same tokens as
    :func:`generate_static`."""
    dev = runner.device
    prompts = _long(prompts, dev)
    plens = _long(plens, dev)
    gen_targets = _long(gen_targets, dev)
    b, p = prompts.shape
    req_ids = (torch.arange(b, device=dev) if req_ids is None
               else _long(req_ids, dev))
    if cache_len is None:
        cache_len = p + max_new
    caches = runner.init_caches(b, cache_len)
    with torch.inference_mode():
        logits_all, caches = runner.prefill(params, caches, prompts)
        tok = _row_sample(_last_logits(logits_all, plens).float(), base_key,
                          req_ids, torch.zeros((b,), dtype=torch.long, device=dev),
                          temperature)
        buf = [tok]
        pos = plens
        for i in range(1, max_new):
            logits, caches = runner.decode(params, tok[:, None], caches, pos)
            active = i < gen_targets
            nxt = _row_sample(logits.float(), base_key, req_ids,
                              torch.full((b,), i, dtype=torch.long, device=dev),
                              temperature)
            tok = torch.where(active, nxt, tok)
            buf.append(torch.where(active, tok, torch.zeros_like(tok)))
            pos = torch.where(active, pos + 1, pos)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # the v0 loop's per-token host sync
    toks = torch.stack(buf, dim=1)
    n_gen = torch.clamp(gen_targets, max=max_new)
    mask = torch.arange(max_new, device=dev)[None, :] < n_gen[:, None]
    return torch.where(mask, toks, torch.zeros_like(toks)), n_gen
