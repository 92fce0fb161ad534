"""hymba-1.5b [hybrid] — parallel attention + mamba heads [arXiv:2411.13676].

32L, d_model=1600, 25 heads (GQA kv=5), d_ff=5504, vocab=32001,
ssm_state=16.  Every layer runs attention and an SSM head in parallel on
the same input and averages the outputs (hymba's fused-head design).
"""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab=32001,
        mixer="hybrid",
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        mlp="swiglu",
        norm="rmsnorm",
        attn_window=1024,      # hymba uses SWA in most layers
    )
