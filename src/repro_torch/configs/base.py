"""Architecture configuration system (the port's own copy of
``repro.configs.base``).

Every ported architecture gets one module in this package defining a
full-size :class:`ArchConfig` plus a ``reduced()`` variant (2 layers,
d_model<=512, <=4 experts) that the CPU tests instantiate.  The full
configs run on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    # MoE replaces the dense MLP every `every` layers (1 = every layer).
    every: int = 1
    shared_expert: bool = False
    router_aux_weight: float = 0.01
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    expand: int = 2
    conv_width: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # one of FAMILIES
    source: str                      # citation / model card
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int                        # dense MLP hidden (per-expert ff lives in moe)
    vocab: int
    d_head: Optional[int] = None     # explicit head dim (qwen3); default d_model//n_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: one attention layer every `attn_every` layers; rest are SSM.
    attn_every: int = 0
    causal: bool = True              # False => encoder-only (audio)
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu (swiglu) | gelu
    tie_embeddings: bool = False
    # sliding-window attention (tokens); None = full attention.  The
    # long_500k decode shape forces a window for full-attention archs.
    sliding_window: Optional[int] = None
    # modality frontend stub: number of embedding positions supplied by the
    # stubbed encoder for vlm/audio archs (0 for text-only).
    frontend_tokens: int = 0
    param_dtype: str = "bfloat16"
    # paper-faithful optimizer default (the paper uses SGD for most models).
    optimizer: str = "adamw"
    # kernel backends for train/prefill hot paths: "torch" | "cuda" |
    # "auto" ("auto" = the hand-written CUDA kernel for CUDA tensors and
    # the plain PyTorch version for CPU tensors).  attention_backend
    # drives attn_apply; mixer_backend drives the Mamba2 SSD scan.
    attention_backend: str = "auto"
    mixer_backend: str = "auto"

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        if self.d_head is not None:
            return self.d_head
        if self.n_heads == 0:
            return 0
        return self.d_model // self.n_heads

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind string: 'attn' | 'ssm' for the mixer slot."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                kinds.append("ssm")
            elif self.family == "hybrid":
                # Jamba: 1 attention layer per `attn_every` layers
                # (attention at position attn_every//2 of each period).
                kinds.append(
                    "attn" if i % self.attn_every == self.attn_every // 2 else "ssm"
                )
            else:
                kinds.append("attn")
        return tuple(kinds)

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        if self.moe is None:
            return tuple(False for _ in range(self.n_layers))
        return tuple((i % self.moe.every) == (self.moe.every - 1)
                     for i in range(self.n_layers))

    # ---------------- parameter accounting (for autobatch/roofline) -----
    def param_count(self) -> int:
        d, v = self.d_model, self.vocab
        hd = self.head_dim
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        kinds = self.layer_kinds()
        moe_mask = self.moe_layer_mask()
        norm_mult = 2 if self.norm == "layernorm" else 1  # scale (+bias)
        for i in range(self.n_layers):
            total += 2 * d * norm_mult  # pre-norms
            if kinds[i] == "attn":
                total += d * self.n_heads * hd          # q
                total += 2 * d * self.n_kv_heads * hd   # k,v
                total += self.n_heads * hd * d          # o
            else:
                s = self.ssm
                di = s.d_inner(d)
                nh = s.n_heads(d)
                conv_ch = di + 2 * s.n_groups * s.d_state
                # in_proj -> [z, x, B, C, dt]
                total += d * (2 * di + 2 * s.n_groups * s.d_state + nh)
                total += conv_ch * s.conv_width + conv_ch  # depthwise conv + bias
                total += nh * 3             # dt_bias, A_log, D
                total += di                 # gated-norm scale
                total += di * d             # out_proj
            if moe_mask[i]:
                m = self.moe
                total += d * m.n_experts            # router
                total += m.n_experts * 3 * d * m.expert_d_ff
                if m.shared_expert:
                    total += 3 * d * (self.d_ff or m.expert_d_ff)
            elif self.d_ff:
                mult = 3 if self.act == "silu" else 2
                total += mult * d * self.d_ff
        total += d * norm_mult  # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE counts top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full_experts = self.n_layers // m.every * m.n_experts * 3 * self.d_model * m.expert_d_ff
        active_experts = self.n_layers // m.every * m.top_k * 3 * self.d_model * m.expert_d_ff
        return self.param_count() - full_experts + active_experts


_REGISTRY: dict = {}


def register(cfg_full, reduced_fn):
    _REGISTRY[cfg_full.name] = (cfg_full, reduced_fn)
    return cfg_full


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name][0]


def get_reduced(name: str) -> ArchConfig:
    _ensure_loaded()
    return _REGISTRY[name][1]()


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        granite_3_2b,
        mamba2_2_7b,
        stablelm_1_6b,
    )


def reduce_config(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Generic reduced variant: 2 layers, d_model<=512, <=4 experts."""
    changes = dict(
        n_layers=2,
        d_model=min(cfg.d_model, 256),
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        d_head=64 if cfg.d_head is not None else None,
        frontend_tokens=min(cfg.frontend_tokens, 16) if cfg.frontend_tokens else 0,
        param_dtype="float32",
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            expert_d_ff=min(cfg.moe.expert_d_ff, 256),
            every=min(cfg.moe.every, 2),
        )
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=32, head_dim=32, chunk=32)
    if cfg.attn_every:
        changes["attn_every"] = 2
        changes["n_layers"] = 4  # keep one attn + ssm mix
    if cfg.sliding_window:
        changes["sliding_window"] = 64
    changes.update(overrides)
    changes["name"] = cfg.name + "-reduced"
    return dataclasses.replace(cfg, **changes)
