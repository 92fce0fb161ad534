"""rfast-100m — the ~125M-parameter LM of the end-to-end R-FAST training
driver.  Llama-style dense decoder; the same dimensions as
``src/repro/configs/rfast_100m.py``."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="rfast-100m",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        d_ff=2048,
        vocab=32000,
        mixer="attn",
        mlp="swiglu",
        norm="rmsnorm",
    )
