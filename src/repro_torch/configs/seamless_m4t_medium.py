"""SeamlessM4T-medium — enc-dec, multimodal [arXiv:2308.11596].

Audio frontend (mel + conv feature extractor) is a STUB per the brief:
input_specs() provides precomputed frame embeddings (batch, num_frame_tokens,
d_model) consumed by the encoder.  "12L" -> 12 encoder + 12 decoder layers.
kv=16 == heads (MHA).
"""
from repro_torch.configs.base import ArchConfig, ATTN, register

SEAMLESS_M4T_MEDIUM = register(ArchConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    source="SeamlessM4T [arXiv:2308.11596]",
    num_layers=12,               # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    pattern=(ATTN,),
    is_encoder_decoder=True,
    num_encoder_layers=12,
    num_frame_tokens=512,        # stubbed audio frames per example
    use_bias=True,
))
