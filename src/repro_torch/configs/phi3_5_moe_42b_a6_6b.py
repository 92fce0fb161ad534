"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model=4096, 32 heads (GQA kv=8), per-expert d_ff=6400, vocab=32064,
MoE 16e top-2 every layer.  SwiGLU experts, RoPE, RMSNorm.
"""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab=32064,
        mixer="attn",
        moe_experts=16,
        moe_top_k=2,
        mlp="swiglu",
        norm="layernorm",        # phi-3.5 uses LayerNorm-style (ls) norms
    )
