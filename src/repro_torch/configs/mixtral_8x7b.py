"""Mixtral 8x7B — 8 experts top-2, sliding-window attention [arXiv:2401.04088]."""
from repro_torch.configs.base import ArchConfig, ATTN_SWA_MOE, register

MIXTRAL_8X7B = register(ArchConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    source="Mixtral of Experts [arXiv:2401.04088]",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32_000,
    pattern=(ATTN_SWA_MOE,),
    num_experts=8,
    top_k=2,
    sliding_window=4096,
))
