"""xLSTM-1.3B — sLSTM + mLSTM blocks [arXiv:2405.04517].

48 layers at 7:1 mLSTM:sLSTM -> 6 units of [7x mLSTM, 1x sLSTM].
d_ff=0: xLSTM blocks carry their own up/down projections (proj factor 2).
"""
from repro_torch.configs.base import ArchConfig, MLSTM, SLSTM, register

XLSTM_1_3B = register(ArchConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    source="xLSTM [arXiv:2405.04517]",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    pattern=(MLSTM,) * 7 + (SLSTM,),
    num_units=6,
    mlstm_proj_factor=2.0,
    conv1d_width=4,
))
