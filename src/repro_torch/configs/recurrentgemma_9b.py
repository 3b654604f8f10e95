"""RecurrentGemma-9B — RG-LRU + local attention, 1:2 ratio [arXiv:2402.19427].

38 layers = 12 units of [RG-LRU, RG-LRU, local-attn] + 2 trailing RG-LRU.
GQA kv=1 (MQA) on the local-attention layers, window 2048.
"""
from repro_torch.configs.base import ArchConfig, RGLRU, LOCAL_ATTN, register

RECURRENTGEMMA_9B = register(ArchConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    source="Griffin/RecurrentGemma [arXiv:2402.19427]",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    num_units=12,
    remainder=(RGLRU, RGLRU),
    local_window=2048,
    attn_logit_softcap=None,
))
