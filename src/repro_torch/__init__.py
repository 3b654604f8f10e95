"""PyTorch/CUDA port of the DistGNN-MB reproduction.

A second package beside the JAX reference ``repro``: it mirrors that
package's module paths, imports ``torch`` and numpy only (never ``jax``
and nothing of ``repro``), and runs every TPU kernel on its path as a
CUDA C++ kernel written for Hopper (``csrc/``).  Entry points run on the
card unless the caller passes ``device="cpu"``; see :mod:`.device`.

Ported so far:

* single-rank GraphSAGE and GAT serving with the HEC-backed embedding
  cache (``serve/gnn``, ``launch/gnn_serve``), through the fused
  serve-layer kernel (``kernels/serve_fused``) or the GAT AGG kernel
  (``kernels/gat_edge``), and the fused HEC probe + load kernel
  (``kernels/hec_search``);
* distributed minibatch GraphSAGE and GAT training in ``aep`` mode
  (``train/gnn_trainer``, ``launch/train``): R ranks in one process on
  one device over the stacked collective backend (``comm/``), with the
  HEC and the delayed embedding push, through the UPDATE and AGG kernels
  (GraphSAGE) or the GAT AGG kernel (GAT) and their gradients, and the
  HEC probe + load kernel;
* LM serving for the ten transformer configs (``configs/``,
  ``models/transformer``, ``train/lm_trainer``, ``serve/scheduler``):
  prefill, decode and the continuous-batching scheduler in plain torch
  (the reference's LM stack has no Pallas kernel).
"""
from repro_torch.device import resolve_device  # noqa: F401
