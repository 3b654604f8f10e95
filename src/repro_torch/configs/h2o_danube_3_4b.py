"""H2O-Danube3-4B — llama+mistral mix with sliding-window attention [arXiv:2401.16818]."""
from repro_torch.configs.base import ArchConfig, ATTN_SWA, register

H2O_DANUBE_3_4B = register(ArchConfig(
    name="h2o-danube-3-4b",
    arch_type="dense",
    source="H2O-Danube [arXiv:2401.16818]",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32_000,
    pattern=(ATTN_SWA,),
    sliding_window=4096,
))
