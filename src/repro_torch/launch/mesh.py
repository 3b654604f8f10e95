"""The card's constants and the GNN trainer's collective (counterpart of
``repro/launch/mesh.py``, whose TPU v5e constants and jax device meshes
have no use here).

The rates are NVIDIA's data sheet for the card the port measures on,
NVIDIA H100 SXM5 80GB HBM3 (``nvidia-smi`` prints "NVIDIA H100 80GB HBM3"
and its power limit, 700 W at full rate), dense, without sparsity.  A
card set below 700 W runs slower under load: every time measured beside
these peaks names the card and its limit.
"""
from __future__ import annotations

CARD = "NVIDIA H100 SXM5 80GB HBM3"
PEAK_FP32_FLOPS = 67e12      # FLOP/s, float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12     # FLOP/s, TF32 on the tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 450e9            # bytes/s each way, to the host's other cards


def make_gnn_collective(num_ranks: int):
    """The paper's rank-per-partition trainer's collective, a
    ``StackedCollective``: R ranks stacked in one process on one card (the
    counterpart of ``make_gnn_mesh``'s 1-D ``data`` mesh)."""
    from repro_torch.comm.collective import StackedCollective
    return StackedCollective(num_ranks)
