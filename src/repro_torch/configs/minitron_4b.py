"""Minitron-4B — width-pruned Nemotron-4 [arXiv:2407.14679]."""
from repro_torch.configs.base import ArchConfig, ATTN, register

MINITRON_4B = register(ArchConfig(
    name="minitron-4b",
    arch_type="dense",
    source="Minitron: pruned Nemotron [arXiv:2407.14679]",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,          # minitron keeps nemotron's 128 head_dim
    d_ff=9216,
    vocab_size=256_000,
    pattern=(ATTN,),
))
