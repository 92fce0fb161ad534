"""falcon-mamba-7b [ssm] — mamba-1, attention-free [arXiv:2410.05355].

64L, d_model=4096, no attention heads, d_ff=0 (no MLP: the mamba block IS
the layer), vocab=65024, ssm_state=16, d_inner=2*d_model, conv=4.
Sub-quadratic: runs the long_500k shape.
"""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        n_layers=64,
        d_model=4096,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=65024,
        mixer="ssm",
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        norm="rmsnorm",
    )
