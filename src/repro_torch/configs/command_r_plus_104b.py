"""Command R+ 104B — GQA, no bias [hf:CohereForAI/c4ai-command-r-v01 family]."""
from repro_torch.configs.base import ArchConfig, ATTN, register

COMMAND_R_PLUS = register(ArchConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    source="Command R+ [hf:CohereForAI/c4ai-command-r-v01]",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256_000,
    pattern=(ATTN,),
    use_bias=False,
    tie_embeddings=True,   # command-r ties input/output embeddings
))
