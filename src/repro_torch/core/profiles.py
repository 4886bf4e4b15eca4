"""Layer profiles: what the MHSL splitter needs to know about a model.

Port of ``repro.core.profiles`` (pure numpy, float64, so the tables are
bit-equal to the reference's). A ``LayerProfile`` gives, for each of L
split-able layers, parameter bytes, emitted activation bytes, the
cotangent bytes hopping back, forward/backward FLOPs and a leakage
value. ``resnet101_profile`` is the paper's own workload;
``transformer_profile`` derives one from any zoo ``ModelConfig``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig

# per-block kind codes (LayerProfile.kind / ProfileTable.kind): the mixer
# in the low bit-space, +2 when the block's FFN half is an expert bank
KIND_ATTN = 0       # attention mixer + dense MLP
KIND_SSM = 1        # Mamba-2 (SSD) mixer
KIND_ATTN_MOE = 2   # attention mixer + MoE expert bank
KIND_SSM_MOE = 3    # SSM mixer + MoE expert bank
KIND_NAMES = {KIND_ATTN: "attn", KIND_SSM: "ssm",
              KIND_ATTN_MOE: "attn+moe", KIND_SSM_MOE: "ssm+moe"}


def block_kind(cfg: ModelConfig, i: int) -> int:
    """Kind code of block ``i`` of ``cfg`` (KIND_* constants)."""
    base = KIND_SSM if cfg.pattern[i] == "M" else KIND_ATTN
    return base + (2 if cfg.is_moe_block(i) else 0)


@dataclass(frozen=True)
class LayerProfile:
    name: str
    param_bytes: np.ndarray  # (L,)
    act_bytes: np.ndarray  # (L,) activation emitted after layer i
    grad_bytes: np.ndarray  # (L,) cotangent entering layer i from above
    fwd_flops: np.ndarray  # (L,)
    bwd_flops: np.ndarray  # (L,)
    # information value of observing the traffic emitted by layer i
    leak_value: np.ndarray  # (L,)
    # architecture-aware columns (None = homogeneous legacy profile,
    # treated as all-zero state / all-attention blocks)
    state_bytes: np.ndarray = None  # (L,)
    kind: np.ndarray = None  # (L,) int8 block-kind codes (0 = attention)

    @property
    def num_layers(self) -> int:
        return len(self.param_bytes)


@dataclass(frozen=True)
class ProfileTable:
    """Derived per-profile arrays (host numpy float64), built once per
    profile content (see :func:`profile_table`)."""

    act_bits: np.ndarray  # (L,)   activation bits emitted by layer i
    grad_bits: np.ndarray  # (L,)   cotangent bits entering layer i
    leak_norm: np.ndarray  # (L,)   leak_value / max(leak_value)
    fwd_cum: np.ndarray  # (L+1,) cumulative fwd FLOPs, fwd_cum[0] = 0
    bwd_cum: np.ndarray  # (L+1,) cumulative bwd FLOPs
    kind: np.ndarray  # (L,)   int8 block-kind codes
    state_bits: np.ndarray  # (L,)   resident state bits of layer i
    state_cum: np.ndarray  # (L+1,) cumulative state bits, state_cum[0] = 0


def _state_kind(profile: LayerProfile):
    """Normalized (state_bytes, kind) with the legacy-None defaults."""
    L = profile.num_layers
    state = profile.state_bytes
    kind = profile.kind
    if state is None:
        state = np.zeros(L, dtype=np.float64)
    if kind is None:
        kind = np.zeros(L, dtype=np.int8)
    return np.asarray(state, np.float64), np.asarray(kind, np.int8)


def profile_digest(profile: LayerProfile) -> str:
    """Content digest of a profile's arrays (plus name): the cache key of
    :func:`profile_table`, so equal-content profiles share one entry."""
    h = hashlib.blake2b(profile.name.encode(), digest_size=16)
    state, kind = _state_kind(profile)
    for arr in (profile.param_bytes, profile.act_bytes, profile.grad_bytes,
                profile.fwd_flops, profile.bwd_flops, profile.leak_value,
                state, kind):
        arr = np.ascontiguousarray(arr)
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


# content-keyed; bounded by the number of distinct profiles a process touches
_TABLE_CACHE: dict = {}


def profile_table(profile: LayerProfile) -> ProfileTable:
    """Cached :class:`ProfileTable` for ``profile`` (built once per content)."""
    key = profile_digest(profile)
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    state, kind = _state_kind(profile)
    state_bits = state * 8.0
    table = ProfileTable(
        act_bits=profile.act_bytes * 8.0,
        grad_bits=profile.grad_bytes * 8.0,
        leak_norm=profile.leak_value / profile.leak_value.max(),
        fwd_cum=np.concatenate([[0.0], np.cumsum(profile.fwd_flops)]),
        bwd_cum=np.concatenate([[0.0], np.cumsum(profile.bwd_flops)]),
        kind=kind,
        state_bits=state_bits,
        state_cum=np.concatenate([[0.0], np.cumsum(state_bits)]),
    )
    _TABLE_CACHE[key] = table
    return table


def _leak_weights(L: int, floor: float = 0.3) -> np.ndarray:
    """Depth-decaying data-leakage risk: layer 0 risks raw-data leakage,
    deep layers leak increasingly task-specific features [20]."""
    return np.linspace(1.0, floor, L)


def transformer_profile(
    cfg: ModelConfig, batch: int, seq: int, *, bytes_per_param: int = 4,
    act_bytes_per_el: int = 2,
) -> LayerProfile:
    """Per-block profile of a zoo architecture, derived exactly from its
    config: parameter bytes, emitted activation (plus SSM state at an 'M'
    boundary), 2·active-params·tokens forward FLOPs plus the causal
    attention term, backward = 2x forward, and the resident per-block
    state (KV cache, SSM scan + conv state, MoE expert banks)."""
    L = cfg.num_layers
    d = cfg.d_model
    pb = np.array([cfg.block_params(i) for i in range(L)], dtype=np.float64)
    pb *= bytes_per_param
    act = np.full(L, batch * seq * d * act_bytes_per_el, dtype=np.float64)
    # SSM boundary also carries the recurrent state
    for i, kind in enumerate(cfg.pattern):
        if kind == "M":
            sc = cfg.ssm
            nh = sc.num_heads(d)
            act[i] += batch * nh * sc.head_dim * sc.d_state * 4
    grad = np.full(L, batch * seq * d * act_bytes_per_el, dtype=np.float64)
    active = np.array([cfg.active_block_params(i) for i in range(L)], dtype=np.float64)
    fwd = 2.0 * active * batch * seq
    # attention quadratic term (full attention; window caps it)
    for i, kind in enumerate(cfg.pattern):
        if kind == "A":
            ctx = min(seq, cfg.attention_window or seq)
            fwd[i] += 2.0 * 2.0 * batch * seq * ctx * cfg.num_heads * cfg.head_dim * 0.5
    bwd = 2.0 * fwd
    leak = act * _leak_weights(L)
    state = np.zeros(L, dtype=np.float64)
    kinds = np.zeros(L, dtype=np.int8)
    for i, kind in enumerate(cfg.pattern):
        kinds[i] = block_kind(cfg, i)
        if kind == "A":
            ctx = min(seq, cfg.attention_window or seq)
            state[i] += (batch * ctx * 2 * cfg.num_kv_heads * cfg.head_dim
                         * act_bytes_per_el)
        else:
            sc = cfg.ssm
            nh = sc.num_heads(d)
            state[i] += batch * nh * sc.head_dim * sc.d_state * 4
            state[i] += batch * (sc.d_inner(d) + 2 * sc.d_state) * (sc.d_conv - 1) * 4
        if cfg.is_moe_block(i):
            state[i] += cfg.mlp_params(True) * bytes_per_param
    return LayerProfile(
        name=cfg.name,
        param_bytes=pb,
        act_bytes=act,
        grad_bytes=grad,
        fwd_flops=fwd,
        bwd_flops=bwd,
        leak_value=leak,
        state_bytes=state,
        kind=kinds,
    )


# (blocks, in_ch, mid_ch, out_ch, spatial) per ResNet-101 stage @224x224
_RESNET101_STAGES: List[Tuple[int, int, int, int, int]] = [
    (3, 64, 64, 256, 56),
    (4, 256, 128, 512, 28),
    (23, 512, 256, 1024, 14),
    (3, 1024, 512, 2048, 7),
]


def resnet101_profile(batch: int = 1, *, image: int = 224,
                      act_bytes_per_el: int = 2) -> LayerProfile:
    """Bottleneck-block granularity (33 blocks + stem + fc = 35 layers).

    Activations hop the wireless links in fp16 (2 B/el): the paper's 8 s /
    75 J Table-I budgets are only satisfiable at ~Mbps TDMA rates with
    half-precision feature transmission.
    """
    params, acts, flops = [], [], []
    # stem: 7x7/2 conv 3->64 + pool -> 56x56
    params.append(7 * 7 * 3 * 64 * 4)
    acts.append(batch * 64 * 56 * 56 * act_bytes_per_el)
    flops.append(2 * 7 * 7 * 3 * 64 * batch * 112 * 112)
    for blocks, cin, mid, cout, sp in _RESNET101_STAGES:
        for bidx in range(blocks):
            ci = cin if bidx == 0 else cout
            p = (ci * mid + 9 * mid * mid + mid * cout) * 4
            if bidx == 0 and ci != cout:
                p += ci * cout * 4  # downsample projection
            params.append(p)
            acts.append(batch * cout * sp * sp * act_bytes_per_el)
            flops.append(2 * (ci * mid + 9 * mid * mid + mid * cout) * batch * sp * sp)
    # classifier
    params.append(2048 * 1000 * 4)
    acts.append(batch * 1000 * act_bytes_per_el)
    flops.append(2 * 2048 * 1000 * batch)
    pb = np.asarray(params, dtype=np.float64)
    ab = np.asarray(acts, dtype=np.float64)
    fw = np.asarray(flops, dtype=np.float64)
    return LayerProfile(
        name="resnet101",
        param_bytes=pb,
        act_bytes=ab,
        grad_bytes=ab.copy(),
        fwd_flops=fw,
        bwd_flops=2 * fw,
        leak_value=ab * _leak_weights(len(pb)),
    )


def get_profile(name: str, batch: int, seq: int = 0) -> LayerProfile:
    """``"resnet101"`` or a zoo arch id (``transformer_profile`` at ``seq``,
    2048 when 0)."""
    if name == "resnet101":
        return resnet101_profile(batch)
    from repro_torch.configs import get_config

    return transformer_profile(get_config(name), batch, seq or 2048)
