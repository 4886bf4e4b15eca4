"""Plain reference of a pre-norm decoder LM and of its training step.

The architecture of Qwen2 / Qwen3-MoE as the configuration file states it
(Hugging Face keys): token embedding; per layer RMSNorm, grouped-query
attention with rotary embeddings (the rotate-half convention) and an
optional QKV bias, residual; RMSNorm, a SwiGLU MLP or a routed mixture of
SwiGLU experts (softmax router, top-k, gates renormalized to sum to one),
residual; final RMSNorm, LM head (tied to the embedding or not), mean
cross-entropy. Everything is f32 with TF32 off, every routed token is
computed, and each expert runs on exactly its tokens. Above
``QUERY_BLOCK`` queries the attention runs in blocks of queries, each
under ``torch.utils.checkpoint``; at or below it, in one call.

The weights are a flat ``{path: tensor}`` dict in the layout the
benchmark made them in: per-layer leaves stacked on a leading axis under
``slots/<j>/...`` (layer ``r`` is row ``r // P`` of slot ``r % P``).

``mm`` is the one place a parameter's matrix product is taken:
:func:`exact_mm` (f32), or :func:`fp8_mm`, the same product on operands
rounded to float8 e4m3 with a per-tensor scale (the benchmark's control;
the gradient passes the rounding unchanged). The router's product and
the attention scores stay f32 in both.

:func:`train_steps` takes the training step of the configuration (the
mean of the microbatches' losses, the clip by the global gradient norm,
AdamW) from the same weights and batches, and returns what the benchmark
compares.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor
Params = Dict[str, Tensor]

F8_MAX = 448.0  # largest float8 e4m3fn value
# queries whose f32 scores one attention call holds: above it the queries go
# in blocks against their causal prefix of keys, each block recomputed in the
# backward, so that one block's scores exist at a time (16 heads x 8 192
# keys x 2 048 queries is 1.07 GB)
QUERY_BLOCK = 2048


def exact_mm(a: Tensor, w: Tensor) -> Tensor:
    return a @ w


def _f8(x: Tensor) -> Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale (amax -> 448); the
    gradient passes straight through."""
    s = x.detach().abs().amax().clamp(min=1e-30) / F8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x.detach())


def fp8_mm(a: Tensor, w: Tensor) -> Tensor:
    return _f8(a) @ _f8(w)


MATMULS: Dict[str, Callable[[Tensor, Tensor], Tensor]] = {
    "float32": exact_mm, "float8_e4m3": fp8_mm}


def strict_f32() -> None:
    """f32 products in f32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rms(x: Tensor, w: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _causal_core(q: Tensor, k: Tensor, v: Tensor, start: int) -> Tensor:
    """Softmax attention of the queries at positions ``start ..`` over the
    keys ``0 ..``, each query seeing the keys up to its own position:
    ``(b, sq, h, hd)`` from q ``(b, sq, h, hd)`` and k, v ``(b, sk, h, hd)``."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    pos = torch.arange(start, start + q.shape[1], device=q.device)
    causal = torch.arange(k.shape[1], device=q.device)[None, :] <= pos[:, None]
    w = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


class DecoderLM:
    """The model of configuration ``conf`` (a configuration file's dict)."""

    def __init__(self, conf, mm: Callable[[Tensor, Tensor], Tensor] = exact_mm):
        self.conf, self.mm = conf, mm
        self.d = conf["hidden_size"]
        self.h = conf["num_attention_heads"]
        self.kh = conf["num_key_value_heads"]
        self.hd = int(conf.get("head_dim") or self.d // self.h)
        self.layers = conf["num_hidden_layers"]
        self.eps = float(conf["rms_norm_eps"])
        self.theta = float(conf["rope_theta"])
        self.tied = bool(conf["tie_word_embeddings"])
        self.bias = bool(conf.get("qkv_bias") or conf.get("attention_bias"))
        self.experts = int(conf.get("num_experts") or 0)
        self.top_k = int(conf.get("num_experts_per_tok") or 0)
        if self.experts and not conf.get("norm_topk_prob", False):
            raise ValueError("the reference renormalizes the top-k gates")
        if conf.get("hidden_act", "silu") != "silu":
            raise ValueError("the reference's MLPs are SwiGLU")

    # -- layers -----------------------------------------------------------

    def _w(self, p: Params, r: int, name: str) -> Tensor:
        period = sum(1 for k in p if k.startswith("slots/") and k.endswith("/norm1"))
        return p[f"slots/{r % period}/{name}"][r // period]

    def _attention(self, p: Params, r: int, x: Tensor, cos, sin) -> Tensor:
        b, s, _ = x.shape
        h, kh, hd = self.h, self.kh, self.hd
        q = self.mm(x, self._w(p, r, "attn/wq"))
        k = self.mm(x, self._w(p, r, "attn/wk"))
        v = self.mm(x, self._w(p, r, "attn/wv"))
        if self.bias:
            q = q + self._w(p, r, "attn/bq")
            k = k + self._w(p, r, "attn/bk")
            v = v + self._w(p, r, "attn/bv")
        q = _rope(q.view(b, s, h, hd), cos, sin)
        k = _rope(k.view(b, s, kh, hd), cos, sin)
        v = v.view(b, s, kh, hd)
        k = k.repeat_interleave(h // kh, dim=2)  # head i reads KV head i // (h / kh)
        v = v.repeat_interleave(h // kh, dim=2)
        if s <= QUERY_BLOCK:
            o = _causal_core(q, k, v, 0)
        else:  # one block's f32 scores at a time, forward and backward
            o = torch.cat([checkpoint(_causal_core, q[:, i:i + QUERY_BLOCK],
                                      k[:, :i + QUERY_BLOCK], v[:, :i + QUERY_BLOCK], i,
                                      use_reentrant=False)
                           for i in range(0, s, QUERY_BLOCK)], dim=1)
        return self.mm(o.reshape(b, s, h * hd), self._w(p, r, "attn/wo"))

    def _swiglu(self, x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor) -> Tensor:
        return self.mm(F.silu(self.mm(x, wg)) * self.mm(x, wu), wd)

    def _moe(self, p: Params, r: int, x: Tensor) -> Tensor:
        b, s, d = x.shape
        xt = x.reshape(b * s, d)
        probs = torch.softmax(xt @ self._w(p, r, "moe/router"), dim=-1)
        gates, ids = torch.topk(probs, self.top_k, dim=-1)
        gates = gates / gates.sum(-1, keepdim=True)
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=self.experts).tolist()
        wg, wu, wd = (self._w(p, r, f"moe/{n}") for n in ("w_gate", "w_up", "w_down"))
        y = torch.zeros_like(xt)
        start = 0
        for e, n in enumerate(counts):
            if n == 0:
                continue
            choice = order[start:start + n]
            start += n
            rows = choice // self.top_k
            out = self._swiglu(xt[rows], wg[e], wu[e], wd[e])
            y = y.index_add(0, rows, out * gates.reshape(-1)[choice, None])
        return y.reshape(b, s, d)

    def _mlp(self, p: Params, r: int, x: Tensor) -> Tensor:
        if self.experts:
            return self._moe(p, r, x)
        return self._swiglu(x, self._w(p, r, "mlp/w_gate"), self._w(p, r, "mlp/w_up"),
                            self._w(p, r, "mlp/w_down"))

    # -- the model ----------------------------------------------------------

    def loss(self, p: Params, tokens: Tensor, labels: Tensor) -> Tensor:
        """Mean cross-entropy of ``labels`` after ``tokens`` (both (B, S))."""
        s = tokens.shape[1]
        inv = 1.0 / (self.theta ** (torch.arange(0, self.hd, 2, dtype=torch.float32,
                                                 device=tokens.device) / self.hd))
        ang = torch.arange(s, dtype=torch.float32, device=tokens.device)[:, None] * inv
        cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
        x = p["embed"][tokens]
        for r in range(self.layers):
            x = x + self._attention(p, r, _rms(x, self._w(p, r, "norm1"), self.eps),
                                    cos, sin)
            x = x + self._mlp(p, r, _rms(x, self._w(p, r, "norm2"), self.eps))
        head = p["embed"].T if self.tied else p["lm_head"]
        logits = self.mm(_rms(x, p["final_norm"], self.eps), head)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


@dataclass
class Readings:
    """What a run of training steps gives the comparison: each step's loss
    and gradient norm (before the clip), each leaf's norm of the first
    step's gradient before and after the clip, the clipped gradient's
    values at each leaf's sampled positions (CPU, f32), and each leaf's
    norm of the parameters' change over the steps."""

    loss: List[float] = field(default_factory=list)
    norm: List[float] = field(default_factory=list)
    grad: Dict[str, float] = field(default_factory=dict)
    raw_grad: Dict[str, float] = field(default_factory=dict)
    grad_sample: Dict[str, Tensor] = field(default_factory=dict)
    change: Dict[str, float] = field(default_factory=dict)


def train_steps(conf, params: Params, batches: Sequence[Tuple[Tensor, Tensor]],
                microbatches: int, optimizer, mm=exact_mm,
                sample: Dict[str, Tensor] = None, block_rows: int = 0) -> Readings:
    """Take ``len(batches)`` training steps of ``conf`` from ``params``
    (which are updated in place): per step, the mean over ``microbatches``
    equal row blocks of their mean cross-entropy, its gradient, the clip
    by the global norm (``optimizer["max_grad_norm"]``) and one AdamW
    update (``lr``, ``b1``, ``b2``, ``eps``, ``weight_decay``).
    ``sample``: per leaf, the flat positions of the first clipped
    gradient to keep. ``block_rows``: rows taken by one forward and
    backward (a multiple of a microbatch's; 0: one microbatch); the mean
    of equal microbatches' means is the mean over their rows."""
    model = DecoderLM(conf, mm)
    lr, b1, b2 = optimizer["lr"], optimizer["b1"], optimizer["b2"]
    eps, wd = optimizer["eps"], optimizer.get("weight_decay", 0.0)
    max_norm = optimizer["max_grad_norm"]
    out = Readings()
    start = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    for step, (tokens, labels) in enumerate(batches, start=1):
        for t in params.values():
            t.requires_grad_(True)
            t.grad = None
        n = tokens.shape[0]
        rows = min(block_rows or n // microbatches, n)
        if rows % (n // microbatches) or n % rows:
            raise ValueError(f"{rows} rows a block do not group the microbatches of {n} rows")
        total = torch.zeros((), device=tokens.device)
        for i in range(0, n, rows):
            li = model.loss(params, tokens[i:i + rows], labels[i:i + rows]) * (rows / n)
            li.backward()
            total += li.detach()
        grads = {k: t.grad for k, t in params.items()}
        for t in params.values():
            t.requires_grad_(False)
            t.grad = None
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
            out.loss.append(float(total))
            out.norm.append(float(norm))
            for k, g in grads.items():
                if step == 1:
                    out.raw_grad[k] = float(torch.linalg.vector_norm(g))
                g.mul_(scale)
                if step == 1:
                    out.grad[k] = float(torch.linalg.vector_norm(g))
                    if sample is not None:
                        idx = sample[k].to(g.device)
                        out.grad_sample[k] = g.reshape(-1)[idx].float().cpu()
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m[k] / (1 - b1 ** step)) / (torch.sqrt(v2[k] / (1 - b2 ** step)) + eps)
                if wd:
                    params[k].mul_(1 - lr * wd)
                params[k].sub_(lr * u)
            del grads
    with torch.no_grad():
        for k, p in params.items():
            out.change[k] = float(torch.linalg.vector_norm(p - start[k]))
    return out
