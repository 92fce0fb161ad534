"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783].

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=128256.
"""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=128256,
        mixer="attn",
        mlp="swiglu",
        norm="rmsnorm",
        rope_theta=500_000.0,
    )
