"""Model / MoE / SSM configuration dataclasses, the port's copy of the
reference's ``repro/configs/base.py`` (pure dataclasses; no change)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

__all__ = ["MoEConfig", "SSMConfig", "EncoderConfig", "ModelConfig", "LayerKind"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    period: int = 1                # MoE MLP every `period` layers (jamba: 2)
    router_norm: str = "topk_softmax"   # mixtral: softmax over selected top-k
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128             # N
    d_conv: int = 4                # K, the depthwise causal conv (our kernel!)
    expand: int = 2
    head_dim: int = 64             # P
    n_groups: int = 1              # G (B/C groups)
    chunk: int = 256               # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim

    def conv_dim(self, d_model: int) -> int:
        # conv runs over (x, B, C): d_inner + 2 * G * N channels
        return self.d_inner(d_model) + 2 * self.n_groups * self.d_state


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    max_frames: int = 1500         # stubbed modality frontend sequence length


@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str = "attn"            # attn | mamba | cross_attn
    mlp: str = "dense"             # dense | moe | none
    window: Optional[int] = None   # sliding-window size for this layer


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention features
    rope_theta: float = 10000.0
    use_rope: bool = True
    window: Optional[int] = None          # SWA window (None = full)
    local_global_period: int = 0          # gemma2: 2 (even layers local)
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    attn_scale: Optional[float] = None    # None -> head_dim ** -0.5
    qk_norm: bool = False
    use_bias: bool = False
    learned_pos: bool = False             # whisper decoder

    # mlp / norms
    mlp_act: str = "swiglu"               # swiglu | gelu
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    norm_eps: float = 1e-5
    post_norm: bool = False               # gemma2 sandwich norms
    embed_scale: bool = False             # gemma: x *= sqrt(d_model)
    tie_embeddings: bool = True

    # structure
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_period: int = 1                  # jamba: 8 (one attn layer per period)
    attn_offset: int = 0                  # index of the attn layer in a period
    cross_attn_period: int = 0            # llama-vision: 5
    n_img_tokens: int = 0
    encoder: Optional[EncoderConfig] = None

    max_seq_len: int = 131072
    dtype: str = "bfloat16"          # activation/compute storage dtype
    param_dtype: str = "float32"     # production configs use bfloat16

    # ------------------------------------------------------------------
    @property
    def period(self) -> int:
        """Layer-pattern period: the scan body covers one period."""
        p = 1
        for q in (self.attn_period if self.ssm and self.attn_period > 1 else 1,
                  self.local_global_period or 1,
                  self.cross_attn_period or 1,
                  self.moe.period if self.moe else 1):
            p = p * q // _gcd(p, q)
        assert self.n_layers % p == 0, (self.name, self.n_layers, p)
        return p

    def layer_kinds(self) -> List[LayerKind]:
        """Per-layer (mixer, mlp, window) pattern for one period."""
        kinds = []
        for i in range(self.period):
            if self.ssm and self.attn_period > 1:
                mixer = "attn" if i % self.attn_period == self.attn_offset else "mamba"
            elif self.ssm:
                mixer = "mamba"
            else:
                mixer = "attn"
            if self.cross_attn_period and (i % self.cross_attn_period ==
                                           self.cross_attn_period - 1):
                mixer = "cross_attn"
            if self.ssm and not self.moe:
                mlp = "none"                     # pure mamba2: no MLP
            elif self.moe and i % self.moe.period == (self.moe.period - 1 if
                                                      self.moe.period > 1 else 0):
                mlp = "moe"
            else:
                mlp = "dense"
            window = self.window
            if self.local_global_period:
                # gemma2: alternating local/global — even layers local (SWA)
                window = self.window if i % self.local_global_period == 0 else None
            kinds.append(LayerKind(mixer=mixer, mlp=mlp, window=window))
        return kinds

    def n_params(self) -> int:
        """Analytical parameter count (for 6ND roofline math)."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            k = self.layer_kinds()[i % self.period]
            if k.mixer in ("attn", "cross_attn"):
                total += d * self.n_heads * self.head_dim * 2      # q, o
                total += d * self.n_kv_heads * self.head_dim * 2   # k, v
            elif k.mixer == "mamba":
                s = self.ssm
                di, cd = s.d_inner(d), s.conv_dim(d)
                nh = s.n_heads(d)
                total += d * (2 * di + 2 * s.n_groups * s.d_state + nh)  # in_proj
                total += cd * s.d_conv + di * d + 2 * nh + di            # conv, out, A/dt/D
            if k.mlp == "dense":
                mult = 3 if self.mlp_act == "swiglu" else 2
                total += mult * d * self.d_ff
            elif k.mlp == "moe":
                total += self.moe.n_experts * 3 * d * self.moe.d_ff
                total += d * self.moe.n_experts                     # router
        if self.encoder:
            per = (d * self.n_heads * self.head_dim * 2
                   + d * self.n_kv_heads * self.head_dim * 2
                   + 2 * d * self.d_ff)
            total += self.encoder.n_layers * per
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.moe:
            return self.n_params()
        total = self.n_params()
        moe_layers = sum(1 for i in range(self.n_layers)
                         if self.layer_kinds()[i % self.period].mlp == "moe")
        dead = (self.moe.n_experts - self.moe.top_k) * 3 * self.d_model * self.moe.d_ff
        return total - moe_layers * dead


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a
