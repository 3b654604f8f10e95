"""Qwen2-VL-7B — M-RoPE, dynamic resolution [arXiv:2409.12191].

Vision frontend is a STUB per the brief: input_specs() provides precomputed
patch embeddings (batch, num_patch_tokens, d_model) prepended to the token
stream.  M-RoPE splits the rotary dims into (temporal, height, width)
sections driven by 3D position ids.
"""
from repro_torch.configs.base import ArchConfig, ATTN, register

QWEN2_VL_7B = register(ArchConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    source="Qwen2-VL [arXiv:2409.12191]",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152_064,
    pattern=(ATTN,),
    use_bias=True,          # qwen2 uses qkv bias
    mrope_sections=(32, 16, 16),   # t/h/w rotary pairs (sum = head_dim/2 = 64)
    num_patch_tokens=256,   # stubbed vision patches per example
    rope_theta=1_000_000.0,
))
