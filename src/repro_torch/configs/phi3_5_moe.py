"""Phi-3.5-MoE 42B (6.6B active) — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import ArchConfig, ATTN_MOE, register

PHI3_5_MOE = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    source="Phi-3.5-MoE [hf:microsoft/Phi-3.5-MoE-instruct]",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32_064,
    pattern=(ATTN_MOE,),
    num_experts=16,
    top_k=2,
))
