"""Batched serving example: one static generate.

    PYTHONPATH=src python -m repro_torch.examples.serve --arch qwen2_5_3b \
        --batch 4 --prompt-len 64 --gen 32 [--device cpu]

The counterpart of the JAX package's ``examples/serve.py``, with its
arguments: a padded batched prefill and the decode steps of
:func:`repro_torch.serving.batching.generate_static` through a
``SingleDeviceRunner``, on the reduced config of ``--arch`` (as the
reference's ``ServeConfig`` gives it). Weights are random, from seed 0;
prompts are ``np.random.default_rng(0)``'s, as in the reference. It runs
on the card unless ``--device cpu`` is given, and prints tokens/s
beside the device's name (the prefill included; nothing compiles). The
continuous service with request arrivals is ``repro_torch.launch.serve``.
:func:`serve` returns what ``main`` prints.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import init_params
from repro_torch.serving import SingleDeviceRunner, generate_static
from repro_torch.serving.config import ServeConfig


def example_prompts(cfg: ModelConfig, batch: int, prompt_len: int) -> np.ndarray:
    """The reference's prompts: ``default_rng(0)`` token ids (B, P)."""
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)


def serve(cfg: ModelConfig, params=None, *, batch: int = 4, prompt_len: int = 64,
          gen: int = 32, temperature: float = 0.0, prompts=None,
          device: DeviceLike = None) -> Dict[str, Any]:
    """One ``generate_static`` of ``batch`` prompts of ``prompt_len``
    tokens and ``gen`` new tokens each. ``params``: the model's weights
    (``init_params`` from seed 0 when None); ``prompts``: (B, P) token ids
    (:func:`example_prompts` when None). Returns the generated tokens
    (B, gen), the counts generated, the seconds and tokens/s of the call
    (prefill included) and the device's name."""
    dev = resolve_device(device)
    if params is None:
        params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             device=dev)
    runner = SingleDeviceRunner(cfg, device=dev)
    if prompts is None:
        prompts = example_prompts(cfg, batch, prompt_len)
    batch, prompt_len = prompts.shape
    plens = np.full((batch,), prompt_len, np.int32)
    gens = np.full((batch,), gen, np.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    toks, n_gen = generate_static(runner, params, prompts, plens, gens,
                                  max_new=gen, temperature=temperature)
    toks, n_gen = toks.cpu(), n_gen.cpu()  # waits for the device
    secs = time.perf_counter() - t0
    total = int(n_gen.sum())
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return dict(tokens=toks, n_gen=n_gen, seconds=secs,
                tokens_per_s=total / max(secs, 1e-9), device=name,
                batch=batch, prompt_len=prompt_len, gen=gen)


def main(argv: Optional[Sequence[str]] = None, params=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = ServeConfig(arch=args.arch.replace("-", "_").replace(".", "_")).model_config()
    res = serve(cfg, params, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, temperature=args.temperature, device=args.device)
    print(f"generate: {args.batch}x{args.prompt_len}+{args.gen} in "
          f"{res['seconds'] * 1e3:.1f} ms ({res['tokens_per_s']:.0f} tok/s, prefill "
          f"included, nothing compiled) on {res['device']}")
    print("sample generations (token ids):")
    for b in range(min(args.batch, 2)):
        print(f"  [{b}] {res['tokens'][b][:16].tolist()} ...")
    return res


if __name__ == "__main__":
    main()
