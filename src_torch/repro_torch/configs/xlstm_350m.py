"""xLSTM 350M [arXiv:2405.04517].

24L d_model=1024 4H vocab=50304, d_ff=0 (blocks carry their own
projections).  Block ratio mLSTM:sLSTM = 7:1 (the paper's xLSTM[7:1]).
Pure recurrent => runs long_500k.
"""
from repro_torch.config import MLSTM, SLSTM, ModelConfig, register_arch

ARCH_ID = "xlstm-350m"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        source="arXiv:2405.04517",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        block_pattern=(MLSTM,) * 7 + (SLSTM,),
        rope=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="ssm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=512,
        block_pattern=(MLSTM, SLSTM),
        rope=False,
    )


register_arch(ARCH_ID, full, smoke)
