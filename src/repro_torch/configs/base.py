"""Architecture configuration system (own copy of ``repro/configs/base.py``).

Every assigned architecture is a selectable config (``--arch <id>``); the
paper's own GNN models (GraphSAGE / GAT) are configs too.  ``ArchConfig``
covers the whole family pool: dense / MoE / SSM (xLSTM) / hybrid (RG-LRU)
/ VLM / audio enc-dec.

Layer stacking is described as a repeating ``pattern`` of block-type
strings applied ``num_units`` times plus an optional ``remainder`` —
this lets ``model.py`` scan over homogeneous stacked params even for
interleaved hybrids (e.g. recurrentgemma's [rglru, rglru, local] unit).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

# Block type vocabulary used in layer patterns.
ATTN = "attn"                # global GQA/MHA attention + dense FFN
ATTN_SWA = "attn_swa"        # sliding-window attention + dense FFN
ATTN_MOE = "attn_moe"        # attention + MoE FFN
ATTN_SWA_MOE = "attn_swa_moe"
MLSTM = "mlstm"              # xLSTM matrix-memory block (own projections)
SLSTM = "slstm"              # xLSTM scalar-memory block (own projections)
RGLRU = "rglru"              # RG-LRU recurrent block + dense FFN
LOCAL_ATTN = "local_attn"    # RecurrentGemma-style local attention + FFN

RECURRENT_BLOCKS = frozenset({MLSTM, SLSTM, RGLRU})
ATTENTION_BLOCKS = frozenset({ATTN, ATTN_SWA, ATTN_MOE, ATTN_SWA_MOE, LOCAL_ATTN})
MOE_BLOCKS = frozenset({ATTN_MOE, ATTN_SWA_MOE})


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A single architecture; see configs/<id>.py for instances."""

    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | vlm | audio
    source: str                       # citation string from the assignment
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # layer composition (pattern * num_units + remainder == num_layers)
    pattern: Sequence[str] = (ATTN,)
    num_units: int = 0                # 0 -> num_layers repetitions of pattern
    remainder: Sequence[str] = ()

    head_dim: Optional[int] = None    # default d_model // num_heads
    # attention
    sliding_window: Optional[int] = None   # SWA window (attn_swa blocks)
    local_window: int = 2048               # local_attn block window
    attn_logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Sequence[int]] = None  # M-RoPE (qwen2-vl)
    # MoE
    num_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_group_size: int = 2048        # tokens per dispatch group
    moe_impl: str = "einsum"          # einsum (GShard one-hot) | gather (sort-free ragged)
    # xLSTM
    mlstm_proj_factor: float = 2.0
    conv1d_width: int = 4
    # RG-LRU
    rnn_width: Optional[int] = None   # default int(1.5 * d_model) rounded
    # enc-dec (audio)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    # multimodal stubs
    num_patch_tokens: int = 0         # VLM: prepended patch embeddings
    num_frame_tokens: int = 0         # audio: encoder frame embeddings
    # misc
    use_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True
    q_chunk: int = 512                # query chunk for memory-bounded attention

    # ---- derived -----------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_units == 0 and not self.remainder:
            assert self.num_layers % len(self.pattern) == 0, self.name
            object.__setattr__(self, "num_units", self.num_layers // len(self.pattern))
        total = self.num_units * len(self.pattern) + len(self.remainder)
        assert total == self.num_layers, (
            f"{self.name}: pattern*units+remainder = {total} != num_layers {self.num_layers}")
        if self.rnn_width is None:
            object.__setattr__(self, "rnn_width", _round_mult(int(1.5 * self.d_model), 128))

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def supports_long_context(self) -> bool:
        """Eligible for long_500k: sub-quadratic decode (SSM/hybrid/SWA)."""
        blocks = set(self.pattern) | set(self.remainder)
        if blocks & RECURRENT_BLOCKS and not (blocks & {ATTN, ATTN_MOE}):
            return True  # pure recurrent or recurrent+local-attn hybrid
        if self.sliding_window is not None and not (blocks & {ATTN, ATTN_MOE}):
            return True  # every attention layer is windowed
        return False

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs have a decoder

    def active_params(self) -> int:
        """Approximate parameter count active per token (MoE: top_k experts)."""
        return self._param_count(active_only=True)

    def total_params(self) -> int:
        return self._param_count(active_only=False)

    def _param_count(self, active_only: bool) -> int:
        d, hd = self.d_model, self.head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb

        def attn_params():
            return d * (n_q * hd) * 2 + d * (n_kv * hd) * 2  # q,o + k,v

        def ffn_params(width):
            return 3 * d * width  # gated MLP (SwiGLU-style: in/gate/out)

        blocks = list(self.pattern) * self.num_units + list(self.remainder)
        for b in blocks:
            if b in (ATTN, ATTN_SWA, LOCAL_ATTN):
                total += attn_params() + ffn_params(self.d_ff)
            elif b in (ATTN_MOE, ATTN_SWA_MOE):
                e = self.top_k if active_only else self.num_experts
                total += attn_params() + e * ffn_params(self.d_ff) + d * self.num_experts
            elif b == MLSTM:
                inner = int(self.mlstm_proj_factor * d)
                total += 2 * d * inner + inner * d + 3 * inner * hd  # up/gate/down + qkv-ish
            elif b == SLSTM:
                total += 8 * d * d  # 4 gates x (input + recurrent)
            elif b == RGLRU:
                w = self.rnn_width
                total += 2 * d * w + w * d + 2 * w + ffn_params(self.d_ff)
        if self.is_encoder_decoder:
            # encoder stack (self-attn + ffn) + decoder cross-attn
            enc = self.num_encoder_layers * (attn_params() + ffn_params(self.d_ff))
            xattn = len(blocks) * attn_params()
            total += enc + xattn
        return total

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 units, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        heads = max(1, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        n_units = 1
        rem = tuple(self.remainder[:1])
        layers = n_units * len(self.pattern) + len(rem)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=layers,
            num_units=n_units,
            remainder=rem,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d // heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            local_window=min(self.local_window, 64),
            rnn_width=min(self.rnn_width, 384),
            num_encoder_layers=min(self.num_encoder_layers, 2),
            num_patch_tokens=min(self.num_patch_tokens, 16),
            num_frame_tokens=min(self.num_frame_tokens, 32),
            moe_group_size=128,
            mrope_sections=(d // heads // 4, d // heads // 8, d // heads // 8)
            if self.mrope_sections else None,
            dtype="float32",
            remat=False,
        )


def _round_mult(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    assert cfg.name not in _REGISTRY, cfg.name
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # import all config modules for their registration side-effects
    from repro_torch.configs import (  # noqa: F401
        minitron_4b, minitron_8b, xlstm_1_3b, phi3_5_moe, h2o_danube_3_4b,
        mixtral_8x7b, recurrentgemma_9b, command_r_plus_104b, qwen2_vl_7b,
        seamless_m4t_medium,
    )
