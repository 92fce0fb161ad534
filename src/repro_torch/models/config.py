# Copy of src/repro/models/config.py, kept verbatim so the port imports nothing of the
# JAX package.
"""Unified architecture configuration covering all assigned families.

One ``ModelConfig`` describes dense / MoE / SSM / hybrid / VLM / audio
backbones; family-specific behaviour is selected by ``mixer`` /
``attention`` / ``moe_experts`` / ``enc_dec`` / ``frontend`` fields.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int                 # query heads (ignored for pure SSM)
    n_kv_heads: int
    d_ff: int                    # dense MLP hidden (or per-expert hidden)
    vocab: int

    head_dim: int = 0            # 0 -> d_model // n_heads

    # --- token mixer ------------------------------------------------- #
    mixer: str = "attn"          # "attn" | "ssm" | "hybrid"
    attention: str = "gqa"       # "gqa" | "mla"
    attn_window: Optional[int] = None   # sliding window; None = full causal
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    use_rope: bool = True        # False -> sinusoidal absolute positions

    # --- MLA (deepseek-v2) -------------------------------------------- #
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 64
    v_head_dim: int = 0          # 0 -> head_dim

    # --- SSM (mamba-1) ------------------------------------------------ #
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0         # 0 -> ceil(d_model / 16)

    # --- MLP / MoE ----------------------------------------------------- #
    mlp: str = "swiglu"          # "swiglu" | "gelu"
    mlp_bias: bool = False
    moe_experts: int = 0         # 0 -> dense MLP
    moe_top_k: int = 0
    moe_shared: int = 0          # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- norms / embeddings -------------------------------------------- #
    norm: str = "rmsnorm"        # "rmsnorm" | "layernorm" | "nonparam_ln"
    tie_embeddings: bool = False

    # --- structure ------------------------------------------------------ #
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: Optional[str] = None   # "audio" | "vision" (stub embeds)
    frontend_seq: int = 0            # frames / patches per example
    frontend_dim: int = 0            # stub embedding dim

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.mixer not in ("attn", "ssm", "hybrid"):
            raise ValueError(f"bad mixer {self.mixer}")
        if self.attention not in ("gqa", "mla"):
            raise ValueError(f"bad attention {self.attention}")
        if self.mixer != "ssm":
            if self.n_heads <= 0:
                raise ValueError("attention mixer needs n_heads > 0")
            if self.attention == "gqa" and self.n_heads % max(1, self.n_kv_heads):
                raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.mixer in ("ssm", "hybrid") and self.ssm_state <= 0:
            raise ValueError("ssm mixer needs ssm_state > 0")
        if self.moe_experts and not self.moe_top_k:
            raise ValueError("MoE needs moe_top_k")
        if self.enc_dec and self.n_enc_layers <= 0:
            raise ValueError("enc_dec needs n_enc_layers")

    # derived ----------------------------------------------------------- #
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def v_hd(self) -> int:
        return self.v_head_dim or self.hd

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    def reduced(self, *, n_layers: int = 2, max_d_model: int = 256,
                max_experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """Smoke-test variant of the same family (2 layers, tiny dims)."""
        d = min(self.d_model, max_d_model)
        # keep head structure ratios but shrink
        if self.mixer == "ssm":
            heads, kv = 0, 0
        else:
            ratio = max(1, self.n_heads // max(1, self.n_kv_heads))
            heads = max(ratio, 4)
            heads -= heads % ratio
            kv = max(1, heads // ratio)
        hd = max(8, (d // max(1, heads)) // 8 * 8) if heads else 0
        experts = min(self.moe_experts, max_experts)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            n_enc_layers=min(self.n_enc_layers, n_layers),
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 2 * d) if self.d_ff else 0,
            vocab=vocab,
            kv_lora_rank=min(self.kv_lora_rank, 32),
            q_lora_rank=min(self.q_lora_rank, 32),
            qk_rope_dim=min(self.qk_rope_dim, hd) if heads else self.qk_rope_dim,
            v_head_dim=hd if self.v_head_dim else 0,
            moe_experts=experts,
            moe_top_k=min(self.moe_top_k, max(1, experts // 2)) if experts else 0,
            moe_shared=min(self.moe_shared, 1),
            frontend_seq=min(self.frontend_seq, 16),
            frontend_dim=min(self.frontend_dim, d) if self.frontend_dim else 0,
        )

    # parameter count (analytic, for roofline MODEL_FLOPS) ---------------- #
    def param_count(self) -> int:
        d, ff, V = self.d_model, self.d_ff, self.vocab
        n = 0
        n += V * d                          # embed
        if not self.tie_embeddings:
            n += d * V                      # lm head
        def attn_params() -> int:
            if self.mixer == "ssm":
                return 0
            if self.attention == "mla":
                r, rq = self.kv_lora_rank, self.q_lora_rank
                qk = self.hd + self.qk_rope_dim
                a = d * r + d * self.qk_rope_dim          # kv down + k_rope
                a += (rq and d * rq + rq * self.n_heads * qk) or d * self.n_heads * qk
                a += r * self.n_heads * (self.hd + self.v_hd)  # k_nope/v up
                a += self.n_heads * self.v_hd * d         # out
                return a
            q = d * self.n_heads * self.hd
            kv = 2 * d * self.n_kv_heads * self.hd
            o = self.n_heads * self.hd * d
            return q + kv + o
        def ssm_params() -> int:
            if self.mixer == "attn":
                return 0
            di, N, dtr = self.d_inner, self.ssm_state, self.dt_rank
            return (d * 2 * di + self.ssm_conv * di + di * (dtr + 2 * N)
                    + dtr * di + di * N + di + di * d)
        def mlp_params() -> int:
            if not ff:
                return 0
            per = (3 if self.mlp == "swiglu" else 2) * d * ff
            if self.moe_experts:
                return ((self.moe_experts + self.moe_shared) * per
                        + d * self.moe_experts)
            return per
        per_layer = attn_params() + ssm_params() + mlp_params()
        n += self.n_layers * per_layer
        if self.enc_dec:
            # encoder self-attn + mlp, decoder extra cross-attn
            enc_layer = attn_params() + mlp_params()
            n += self.n_enc_layers * enc_layer
            n += self.n_layers * attn_params()    # cross-attention
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        if not self.moe_experts:
            return self.param_count()
        full = self.param_count()
        per = (3 if self.mlp == "swiglu" else 2) * self.d_model * self.d_ff
        layers = self.n_layers + (self.n_enc_layers if self.enc_dec else 0)
        inactive = (self.moe_experts - self.moe_top_k) * per * layers
        return full - inactive
