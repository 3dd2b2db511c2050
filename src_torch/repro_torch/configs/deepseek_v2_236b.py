"""DeepSeek-V2 236B [arXiv:2405.04434].

60L d_model=5120 128H, MLA (kv_lora=512, q_lora=1536, nope=128, rope=64),
MoE: 2 shared + 160 routed top-6, per-expert d_ff=1536, first layer dense
(d_ff=12288), vocab 102400.  ~236B total / ~21B active params.
"""
from repro_torch.config import MLAConfig, ModelConfig, MoEConfig, register_arch

ARCH_ID = "deepseek-v2-236b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        source="arXiv:2405.04434",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        d_ff=12288,                     # dense first layer
        vocab_size=102400,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=160, experts_per_token=6,
                      num_shared_experts=2, d_ff=1536,
                      first_dense_layers=1, capacity_factor=1.25),
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=64,
                      qk_nope_head_dim=32, qk_rope_head_dim=16,
                      v_head_dim=32),
        moe=MoEConfig(num_experts=4, experts_per_token=2,
                      num_shared_experts=1, d_ff=64,
                      first_dense_layers=1, capacity_factor=1.5),
    )


register_arch(ARCH_ID, full, smoke)
