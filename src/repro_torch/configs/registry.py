"""The 10 architectures of the reference's registry
(``repro/configs/registry.py``), copied name for name.

Sources per arch are noted inline ([hf]/[arXiv]).
``head_dim`` follows the public model cards where it differs from
d_model/n_heads (gemma2-27b: 128; qwen3 MoE: 128).
"""
from __future__ import annotations

from typing import Callable, Dict

from .base import EncoderConfig, ModelConfig, MoEConfig, SSMConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def _norm(name: str) -> str:
    return name.lower().replace("_", "-").replace(".", "-")


def register(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    _REGISTRY[_norm(fn.__name__)] = fn
    return fn


def get_config(name: str) -> ModelConfig:
    key = _norm(name)
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key]()


def list_archs():
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# [vlm] hf:meta-llama/Llama-3.2-11B-Vision — 40L cross-attn image layers
@register
def llama_3_2_vision_11b() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=128256, rope_theta=500000.0,
        cross_attn_period=5, n_img_tokens=1024, tie_embeddings=False, param_dtype="bfloat16")


# [moe] arXiv:2401.04088 — 8 experts top-2, SWA
@register
def mixtral_8x22b() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=32768, rope_theta=1000000.0, window=4096,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=16384,
                      router_norm="topk_softmax"),
        tie_embeddings=False, param_dtype="bfloat16")


# [moe] hf:Qwen/Qwen3 family — 128 experts top-8, QK-norm
@register
def qwen3_moe_235b_a22b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab_size=151936, rope_theta=1000000.0, qk_norm=True,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff=1536,
                      router_norm="softmax_topk"),
        tie_embeddings=False, param_dtype="bfloat16")


# [audio] arXiv:2212.04356 — enc-dec, conv frontend (stub)
@register
def whisper_medium() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096, vocab_size=51865, use_rope=False, learned_pos=True,
        mlp_act="gelu", norm="layernorm", use_bias=True,
        encoder=EncoderConfig(n_layers=24, max_frames=1500),
        max_seq_len=32768, tie_embeddings=True, param_dtype="bfloat16")


# [dense] arXiv:2401.16818 — llama+mistral mix, SWA
@register
def h2o_danube_1_8b() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense",
        n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
        d_ff=6912, vocab_size=32000, rope_theta=10000.0, window=4096,
        tie_embeddings=False, param_dtype="bfloat16")


# [dense] arXiv:2408.00118 — local+global alternating, logit softcap
@register
def gemma2_27b() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", family="dense",
        n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
        d_ff=36864, vocab_size=256000, rope_theta=10000.0,
        window=4096, local_global_period=2,
        attn_softcap=50.0, final_softcap=30.0,
        attn_scale=(4608 / 32) ** -0.5,        # query_pre_attn_scalar=d/H
        mlp_act="swiglu", post_norm=True, embed_scale=True,
        tie_embeddings=True, param_dtype="bfloat16")


# [dense] arXiv:2401.14196 — llama-arch (56 heads: pad-to-64 TP)
@register
def deepseek_coder_33b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b", family="dense",
        n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=19200, vocab_size=32256, rope_theta=100000.0,
        tie_embeddings=False, param_dtype="bfloat16")


# [dense] arXiv:2402.19173 — GQA, RoPE
@register
def starcoder2_15b() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
        d_ff=24576, vocab_size=49152, rope_theta=100000.0,
        mlp_act="gelu", norm="layernorm", use_bias=True,
        tie_embeddings=False, param_dtype="bfloat16")


# [ssm] arXiv:2405.21060 — SSD (state-space duality)
@register
def mamba2_780m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=50280, use_rope=False,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        tie_embeddings=True, param_dtype="bfloat16")


# [hybrid] arXiv:2403.19887 — Mamba+attn 1:7 interleave, MoE every 2nd layer
@register
def jamba_v0_1_52b() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=65536, use_rope=False,  # jamba: no positional enc
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        attn_period=8, attn_offset=4,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336, period=2,
                      router_norm="topk_softmax"),
        tie_embeddings=False, param_dtype="bfloat16")
