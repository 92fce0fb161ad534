"""whisper-large-v3 [audio] — enc-dec, conv frontend (STUB) [arXiv:2212.04356].

32L decoder + 32L encoder, d_model=1280, 20 heads (MHA: kv=20), d_ff=5120,
vocab=51866.  The mel-spectrogram + conv feature extractor is a stub:
``input_specs`` provides (B, 1500, 1280) frame embeddings.
Whisper uses absolute sinusoidal positions and LayerNorm + GELU + biases.
"""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        n_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab=51866,
        mixer="attn",
        attention="gqa",
        use_rope=False,
        qkv_bias=True,
        mlp="gelu",
        mlp_bias=True,
        norm="layernorm",
        enc_dec=True,
        n_enc_layers=32,
        frontend="audio",
        frontend_seq=1500,       # 30 s of audio at 50 Hz after conv stride
        frontend_dim=1280,
    )
