"""Model configuration — one dataclass covering all assigned families.

Families: dense | moe | hybrid (RG-LRU + local attn) | ssm (RWKV6) |
encdec (whisper) | vlm (cross-attn image layers).

The port's copy of :mod:`repro.models.config`, field for field, so a
configuration means the same model in both packages.  Fields that only
the reference's JAX execution reads (``remat``, ``scan_layers``,
``analysis_unroll``, ``parallelism``) are kept for that reason.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


def _own(default):
    """A field of the port's own (the reference has none of them)."""
    return dataclasses.field(default=default, metadata={"own": True})


def _repr(self) -> str:
    """The dataclass repr without the port's own fields that hold their
    default: the reference's repr wherever a config computes what the
    reference's does, and every departure from it shown."""
    shown = (f for f in dataclasses.fields(self)
             if not f.metadata.get("own")
             or getattr(self, f.name) != f.default)
    return f"{type(self).__qualname__}(" + ", ".join(
        f"{f.name}={getattr(self, f.name)!r}" for f in shown) + ")"


@dataclasses.dataclass(frozen=True, repr=False)
class MoEConfig:
    n_experts: int = 0           # routed experts
    top_k: int = 0
    n_shared: int = 0            # shared (always-on) experts
    d_ff_expert: int = 0         # per-expert hidden dim
    d_ff_shared: int = 0         # shared-expert hidden dim (total)
    first_dense_layers: int = 0  # leading dense layers (deepseek style)
    d_ff_dense: int = 0          # hidden dim of those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # --- the port's own fields: each default computes what the
    # reference computes, and the repr shows them only off it ---
    # the experts held here, an expert-parallel share: experts
    # first_held .. first_held + n_held - 1 (n_held 0 = all); the router
    # keeps all n_experts outputs
    n_held: int = _own(0)
    first_held: int = _own(0)
    norm_topk_prob: bool = _own(True)     # renormalise the top-k scores
    routed_scaling_factor: float = _own(1.0)  # times the routed weights
    dropless: bool = _own(False)  # grouped dispatch, no capacity, no drops
    seq_aux: bool = _own(False)   # balance loss per sequence (DeepSeek-V2)

    __repr__ = _repr

    @property
    def held(self) -> int:
        return self.n_held or self.n_experts


@dataclasses.dataclass(frozen=True)
class YarnConfig:
    """YaRN's rope scaling (DeepSeek-V2's ``rope_scaling``, type yarn)."""
    factor: float = 1.0
    original_max: int = 4096     # original_max_position_embeddings
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True, repr=False)
class MLAConfig:
    kv_lora: int = 0             # compressed KV width (c_kv)
    q_lora: int = 0              # compressed Q width (0 = full-rank Q)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    yarn: Optional[YarnConfig] = _own(None)  # the port's own: None = RoPE

    __repr__ = _repr


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    # layer pattern, e.g. ("lru", "lru", "attn") repeating; remainder = prefix
    pattern: Sequence[str] = ()
    window: int = 2048           # local attention window
    lru_width: int = 0           # RG-LRU recurrent width (0 = d_model)
    conv_width: int = 4          # temporal conv in recurrent block


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 0
    encoder_seq: int = 1500      # whisper audio frames (post conv-stub)
    encoder_causal: bool = False


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    cross_every: int = 0         # a cross-attn layer every k-th layer
    image_tokens: int = 1601     # vision patch tokens (stub-provided)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 = d_model // n_heads
    activation: str = "swiglu"   # swiglu | geglu | relu2 | gelu
    norm: str = "rms"            # rms | layer
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    max_seq: int = 8192
    norm_eps: float = 1e-6
    moe: MoEConfig = MoEConfig()
    mla: Optional[MLAConfig] = None
    hybrid: HybridConfig = HybridConfig()
    encdec: EncDecConfig = EncDecConfig()
    vlm: VLMConfig = VLMConfig()
    # --- numerics / execution ---
    dtype: str = "bfloat16"      # activation/param compute dtype
    param_dtype: str = "bfloat16"
    remat: str = "full"          # full | dots | none
    scan_layers: bool = True
    attn_chunk: int = 1024       # flash-attention KV block
    wkv_chunk: int = 32          # WKV6 chunked-parallel block
    # Analysis (dry-run) mode: unroll every lax.scan so XLA cost_analysis
    # counts all iterations (While bodies are otherwise counted once).
    # Never used for real execution.
    analysis_unroll: bool = False
    # --- training ---
    optimizer: str = "adamw"     # adamw | adafactor
    # parallelism layout: "fsdp_tp" (2-D, default) or "pure_dp" (batch over
    # BOTH mesh axes, params FSDP over data only, no TP) — the right-sizing
    # option for models whose TP collectives dominate at 256 chips.
    parallelism: str = "fsdp_tp"
    # --- sub-quadratic marker (long_500k eligibility) ---
    subquadratic: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)

        def attn_params():
            if self.mla is not None:
                m = self.mla
                qdim = nq * (m.nope_head_dim + m.rope_head_dim)
                q = (d * m.q_lora + m.q_lora * qdim) if m.q_lora else d * qdim
                kv = d * (m.kv_lora + m.rope_head_dim)
                kv += m.kv_lora * nq * (m.nope_head_dim + m.v_head_dim)
                out = nq * m.v_head_dim * d
                return q + kv + out
            return d * hd * (nq + 2 * nkv) + nq * hd * d

        def ffn_params(dff):
            mult = 3 if self.activation == "swiglu" else 2
            return mult * d * dff

        if self.family == "moe":
            m = self.moe
            n_moe = L - m.first_dense_layers
            blk = m.first_dense_layers * ffn_params(m.d_ff_dense or f)
            blk += n_moe * (m.held * ffn_params(m.d_ff_expert)
                            + ffn_params(m.d_ff_shared)
                            + d * m.n_experts)  # router
            blk += L * attn_params()
        elif self.family == "ssm":
            # rwkv6: token-mix (r,k,v,w,g,out ≈ 6 d² low-rank-ish) + channel-mix
            blk = L * (6 * d * d + 2 * d * f)
        elif self.family == "hybrid":
            pat = list(self.hybrid.pattern) or ["attn"]
            n_attn = sum(1 for i in range(L) if pat[i % len(pat)] == "attn")
            n_lru = L - n_attn
            w = self.hybrid.lru_width or d
            blk = n_attn * attn_params() + n_lru * (2 * d * w + w * d + 3 * w)
            blk += L * ffn_params(f)
        else:
            blk = L * (attn_params() + ffn_params(f))
            if self.family == "encdec":
                e = self.encdec
                blk += e.n_encoder_layers * (attn_params() + ffn_params(f))
                blk += L * attn_params()          # decoder cross-attn
            if self.family == "vlm" and self.vlm.cross_every:
                n_cross = L // self.vlm.cross_every
                blk += n_cross * attn_params()
        return emb + blk

    def active_param_count(self) -> int:
        """Activated params per token (MoE top-k accounting)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        full = self.param_count()
        mult = 3 if self.activation == "swiglu" else 2
        n_moe = self.n_layers - m.first_dense_layers
        all_experts = n_moe * m.held * mult * self.d_model * m.d_ff_expert
        active = n_moe * m.top_k * mult * self.d_model * m.d_ff_expert \
            * m.held // m.n_experts
        return full - all_experts + active
