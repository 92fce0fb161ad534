"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 2 shared + 160 routed
experts, top-6 [arXiv:2405.04434].

60L, d_model=5120, 128 heads, per-expert d_ff=1536, vocab=102400.
MLA: kv_lora_rank=512, q_lora_rank=1536, qk_nope=128, qk_rope=64,
v_head=128.  The compressed KV cache (B, S, 512+64) is the whole point.
"""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=1536,
        vocab=102400,
        mixer="attn",
        attention="mla",
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_rope_dim=64,
        v_head_dim=128,
        moe_experts=160,
        moe_top_k=6,
        moe_shared=2,
        mlp="swiglu",
        norm="rmsnorm",
    )
