"""Configuration system (port of ``repro/config.py``).

Every architecture is described by a :class:`ModelConfig`; training /
serving / federated-learning behaviour by :class:`TrainConfig`,
:class:`ServeConfig` and :class:`FLConfig`.  Architectures register
themselves in
:data:`ARCH_REGISTRY` (populated by ``repro_torch.configs``, the same
architectures as the reference's, :func:`list_archs`) and are selectable
via ``--arch <id>``.

The four assigned input shapes are fixed here as :data:`INPUT_SHAPES`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

# ---------------------------------------------------------------------------
# Block kinds understood by the transformer stack.
# ---------------------------------------------------------------------------
ATTN = "attn"            # global self attention (full / GQA / MQA)
SWA = "swa"              # sliding-window attention
MLA = "mla"              # multi-head latent attention (DeepSeek-V2)
MLSTM = "mlstm"          # xLSTM matrix-memory block
SLSTM = "slstm"          # xLSTM scalar-memory block
RGLRU = "rglru"          # RecurrentGemma RG-LRU block
LOCAL_ATTN = "local"     # local attention (RecurrentGemma flavour of SWA)

RECURRENT_KINDS = (MLSTM, SLSTM, RGLRU)
ATTENTION_KINDS = (ATTN, SWA, MLA, LOCAL_ATTN)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for one MoE layer family."""

    num_experts: int = 0              # routed experts
    experts_per_token: int = 0        # top-k
    num_shared_experts: int = 0       # always-on shared experts
    d_ff: int = 0                     # per-expert hidden size
    router_aux_loss: float = 0.01     # load-balance loss coefficient
    router_z_loss: float = 1e-3
    first_dense_layers: int = 0       # leading dense layers (DeepSeek-V2: 1)
    capacity_factor: float = 0.0      # 0 => dropless dense-dispatch baseline

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention settings."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    # identity ------------------------------------------------------------
    name: str = "unnamed"
    family: str = "dense"            # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                 # citation

    # trunk ----------------------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                # 0 => d_model // num_heads
    d_ff: int = 1024                 # dense MLP hidden (0 for pure xLSTM)
    vocab_size: int = 32000
    act: str = "silu"                # silu (SwiGLU) | gelu (GeGLU / plain)
    gated_mlp: bool = True           # False => classic 2-matrix MLP (GPT/Whisper)
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False
    qk_norm: bool = False            # Qwen3-style per-head RMSNorm on q,k
    rope_theta: float = 10000.0
    rope: bool = True

    # layer pattern ---------------------------------------------------------
    # ``block_pattern`` repeats until num_layers is reached.  Empty => all
    # layers are ``attn`` (or ``swa`` if window>0).
    block_pattern: Tuple[str, ...] = ()
    window: int = 0                  # sliding/local attention window (tokens)

    # family-specific -------------------------------------------------------
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: Optional[MLAConfig] = None
    # recurrent blocks
    lru_width: int = 0               # RG-LRU recurrence width (0 => d_model)
    conv_width: int = 4              # temporal conv in RG-LRU block
    mlstm_proj_factor: float = 2.0   # xLSTM mLSTM up-projection
    slstm_proj_factor: float = 4.0 / 3.0

    # encoder-decoder (whisper) ----------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 0             # frames fed to the encoder (post-frontend)

    # modality frontend stub --------------------------------------------------
    frontend: str = ""               # "" | "vision" | "audio"
    num_prefix_tokens: int = 0       # vision patch embeddings prepended

    # numerics / memory --------------------------------------------------------
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"     # master params
    remat: bool = True               # checkpoint each layer (training)
    logits_softcap: float = 0.0
    fsdp_hint: bool = True           # shard params over the data axis (big models)

    # ---------------------------------------------------------------- helpers
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a multiple of 256 (the reference pads it so
        the vocab dim shards); the forward masks the pad columns, so the
        math is exact."""
        return -(-self.vocab_size // 256) * 256

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kinds, length == num_layers (decoder trunk)."""
        if self.block_pattern:
            pat = self.block_pattern
        elif self.window > 0:
            pat = (SWA,)
        elif self.mla is not None:
            pat = (MLA,)
        else:
            pat = (ATTN,)
        reps = -(-self.num_layers // len(pat))
        return (pat * reps)[: self.num_layers]

    @property
    def is_subquadratic(self) -> bool:
        """True when decode over very long context needs no full attention."""
        kinds = set(self.layer_kinds)
        return not (ATTN in kinds or MLA in kinds) and not self.is_encoder_decoder

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 8
    seq_len: int = 128
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    optimizer: str = "adamw"         # sgd | momentum | adam | adamw | adafactor
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    z_loss: float = 0.0
    microbatches: int = 1            # grad-accumulation splits (memory lever)
    seed: int = 0


@dataclass(frozen=True)
class ServeConfig:
    batch: int = 8
    context_len: int = 2048          # KV cache length for decode
    prefill_len: int = 2048


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (1, 1)
    axes: Tuple[str, ...] = ("data", "model")
    fsdp: bool = True                # shard params over the data axis too

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning round structure (paper layer)."""

    num_sites: int = 2
    rounds: int = 3
    local_steps: int = 10
    strategy: str = "fedavg"         # fedavg | fedadam | fedyogi | fedprox | ...
    sync_mode: str = "loose"         # loose (runtime relay) | tight (pod psum)
    proximal_mu: float = 0.0
    server_lr: float = 1.0
    dp_clip: float = 0.0             # 0 disables the DP mod
    dp_noise_multiplier: float = 0.0
    secagg: bool = False
    seed: int = 0


@dataclass(frozen=True)
class Experiment:
    """Everything `--arch X --shape Y` resolves to."""

    model: ModelConfig
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    fl: FLConfig = field(default_factory=FLConfig)


# ---------------------------------------------------------------------------
# Assigned input shapes.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture registry.
# ---------------------------------------------------------------------------
ARCH_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
SMOKE_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_arch(arch_id: str, full: Callable[[], ModelConfig],
                  smoke: Callable[[], ModelConfig]) -> None:
    ARCH_REGISTRY[arch_id] = full
    SMOKE_REGISTRY[arch_id] = smoke


def get_model_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)

    reg = SMOKE_REGISTRY if smoke else ARCH_REGISTRY
    if arch_id not in reg:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(ARCH_REGISTRY)}")
    return reg[arch_id]()


def list_archs() -> Sequence[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(ARCH_REGISTRY)


def shape_supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch, shape) is part of the dry-run matrix."""
    if shape.name == "long_500k" and not (cfg.is_subquadratic or cfg.window > 0):
        return False, "full attention is quadratic at 500k context"
    if shape.name == "long_500k" and cfg.is_encoder_decoder:
        return False, "enc-dec decoder uses full self+cross attention"
    return True, ""
