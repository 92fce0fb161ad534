"""qwen2.5-3b [dense] — GQA + QKV bias [hf:Qwen/Qwen2.5-0.5B family].

36L, d_model=2048, 16 heads (GQA kv=2), d_ff=11008, vocab=151936.
"""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b",
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv_heads=2,
        d_ff=11008,
        vocab=151936,
        mixer="attn",
        qkv_bias=True,
        mlp="swiglu",
        norm="rmsnorm",
        rope_theta=1e6,
        tie_embeddings=True,
    )
