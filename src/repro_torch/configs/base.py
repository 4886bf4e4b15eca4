"""Config system: dataclasses for model / mesh / run configuration.

The port's own copy of ``repro.configs.base``, field for field (pure
Python, no framework), so the port never imports the JAX package.

Every assigned architecture has a module in this package exporting a
``CONFIG: ModelConfig`` with the exact published dimensions (source cited in
its docstring) plus a ``reduced()`` variant used by CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple

ArchType = str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'vlm' | 'audio'


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0          # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    # every `moe_every`-th block is MoE (1 = every block); used by hybrids
    moe_every: int = 1
    # token routing: "dropless" (sort-based grouping, every routed token
    # computed - layers.moe_apply_dropless) or "capacity" (the classic
    # ceil(T*k*cf/E) buffer with token dropping - layers.moe_apply).
    # capacity_factor only matters under "capacity".
    dispatch: str = "dropless"

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 64               # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: ArchType
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    activation: str = "swiglu"        # swiglu | relu2 | gelu
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # attention variants
    attention_window: Optional[int] = None   # sliding window (tokens); None = full
    # MoE / SSM / hybrid structure
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # layout string per block for hybrids: 'A'=attention, 'M'=mamba.
    # None -> homogeneous ('A'*L for attention archs, 'M'*L for ssm archs).
    block_pattern: Optional[str] = None
    # modality frontend stub: 'none' | 'vision' | 'audio'
    frontend: str = "none"
    frontend_tokens: int = 0          # prefix embedding tokens provided by stub
    source: str = ""                  # citation

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived structure -------------------------------------------------
    @property
    def pattern(self) -> str:
        if self.block_pattern is not None:
            assert len(self.block_pattern) == self.num_layers
            return self.block_pattern
        return ("M" if self.arch_type == "ssm" else "A") * self.num_layers

    def is_moe_block(self, i: int) -> bool:
        return self.moe.enabled and (i % max(self.moe.moe_every, 1) == 0)

    @property
    def num_attn_layers(self) -> int:
        return self.pattern.count("A")

    @property
    def num_ssm_layers(self) -> int:
        return self.pattern.count("M")

    # ---- parameter counts --------------------------------------------------
    def attn_params(self) -> int:
        d, h, kh, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        p = d * h * hd + 2 * d * kh * hd + h * hd * d
        if self.qkv_bias:
            p += (h + 2 * kh) * hd
        return p

    def mlp_params(self, moe_block: bool) -> int:
        d = self.d_model
        if moe_block and self.moe.enabled:
            ff = self.moe.expert_d_ff
            per = (3 if self.activation == "swiglu" else 2) * d * ff
            return self.moe.num_experts * per + d * self.moe.num_experts  # + router
        ff = self.d_ff
        return (3 if self.activation == "swiglu" else 2) * d * ff

    def ssm_params(self) -> int:
        d = self.d_model
        di = self.ssm.d_inner(d)
        nh = self.ssm.num_heads(d)
        # in_proj (z,x,B,C,dt) + conv + A,D + norm + out_proj (Mamba-2 layout)
        in_proj = d * (2 * di + 2 * self.ssm.d_state + nh)
        conv = self.ssm.d_conv * (di + 2 * self.ssm.d_state)
        return in_proj + conv + 2 * nh + di + di * d

    def block_params(self, i: int) -> int:
        kind = self.pattern[i]
        p = 2 * self.d_model  # two RMSNorms
        if kind == "A":
            p += self.attn_params() + self.mlp_params(self.is_moe_block(i))
        else:
            p += self.ssm_params() + (
                self.mlp_params(self.is_moe_block(i)) if self.arch_type == "hybrid" else 0
            )
        return p

    def active_block_params(self, i: int) -> int:
        """Params touched per token (MoE counts only top-k experts + router)."""
        p = self.block_params(i)
        if self.is_moe_block(i) and (self.pattern[i] == "A" or self.arch_type == "hybrid"):
            ff = self.moe.expert_d_ff
            per = (3 if self.activation == "swiglu" else 2) * self.d_model * ff
            p -= (self.moe.num_experts - self.moe.top_k) * per
        return p

    def embed_params(self) -> int:
        p = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            p += self.vocab_size * self.d_model
        return p + self.d_model  # final norm

    def param_count(self) -> int:
        return self.embed_params() + sum(self.block_params(i) for i in range(self.num_layers))

    def active_param_count(self) -> int:
        return self.embed_params() + sum(
            self.active_block_params(i) for i in range(self.num_layers)
        )

    # ---- reductions ----------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests (2 layers, d<=512)."""
        d = min(self.d_model, 256)
        nh = min(self.num_heads, 4) or 0
        nkv = min(self.num_kv_heads, max(1, nh // 2)) if self.num_kv_heads else 0
        moe = self.moe
        if moe.enabled:
            moe = replace(moe, num_experts=4, top_k=min(moe.top_k, 2), expert_d_ff=128)
        ssm = replace(self.ssm, d_state=16, head_dim=32)
        pattern = None
        if self.block_pattern is not None:
            pattern = (self.block_pattern[: self.num_layers])
            # keep one attention and one mamba block
            pattern = "AM"
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=64 if nh else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=512,
            moe=moe,
            ssm=ssm,
            block_pattern=pattern,
            attention_window=None if self.attention_window is None else 64,
            frontend_tokens=8 if self.frontend != "none" else 0,
        )

    def with_window(self, window: int) -> "ModelConfig":
        return replace(self, name=self.name + f"-sw{window}", attention_window=window)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in INPUT_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown input shape {name!r}; have {[s.name for s in INPUT_SHAPES]}")


ARCH_IDS: Tuple[str, ...] = (
    "qwen3-moe-235b-a22b",
    "nemotron-4-340b",
    "qwen2.5-3b",
    "jamba-v0.1-52b",
    "minitron-4b",
    "pixtral-12b",
    "musicgen-large",
    "mamba2-370m",
    "stablelm-1.6b",
    "qwen3-moe-30b-a3b",
)

_MODULES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "nemotron-4-340b": "nemotron_4_340b",
    "qwen2.5-3b": "qwen2_5_3b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "minitron-4b": "minitron_4b",
    "pixtral-12b": "pixtral_12b",
    "musicgen-large": "musicgen_large",
    "mamba2-370m": "mamba2_370m",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {list(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
