"""olmo-1b [dense] — non-parametric LayerNorm [arXiv:2402.00838].

16L, d_model=2048, 16 heads (MHA: kv=16), d_ff=8192, vocab=50304.
OLMo: no-bias projections, non-parametric LN, SwiGLU, RoPE, tied embeddings.
"""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab=50304,
        mixer="attn",
        norm="nonparam_ln",
        mlp="swiglu",
        tie_embeddings=True,
    )
