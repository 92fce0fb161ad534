"""deepseek-7b [dense] — llama-arch, MHA [arXiv:2401.02954].

30L, d_model=4096, 32 heads (kv=32: MHA), d_ff=11008, vocab=102400.
"""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        n_layers=30,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=11008,
        vocab=102400,
        mixer="attn",
        mlp="swiglu",
        norm="rmsnorm",
    )
