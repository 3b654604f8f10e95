"""Minitron-8B — width-pruned Nemotron-4 [arXiv:2407.14679]."""
from repro_torch.configs.base import ArchConfig, ATTN, register

MINITRON_8B = register(ArchConfig(
    name="minitron-8b",
    arch_type="dense",
    source="Minitron: pruned Nemotron [arXiv:2407.14679]",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256_000,
    pattern=(ATTN,),
))
