"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo backbone (ViT is a STUB)
[hf:mistralai/Pixtral-12B-2409].

40L, d_model=5120, 32 heads (GQA kv=8), d_ff=14336, vocab=131072.
``input_specs`` provides (B, 256, 1024) patch embeddings (the ViT stub);
they are projected and prepended to the text tokens.
"""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=131072,
        mixer="attn",
        mlp="swiglu",
        norm="rmsnorm",
        rope_theta=1e6,
        frontend="vision",
        frontend_seq=256,        # 1024px/64 patches -> 256 tokens (stub)
        frontend_dim=1024,
    )
