"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ref.py``).  Sources are in ``repro_torch/csrc``; ``_build``
compiles them on first launch.

  serve_fused.serve_fused_layer   <- repro/kernels/serve_fused.py:fused_serve_layer
  hec_search.hec_lookup           <- repro/kernels/hec_search.py:hec_search_kernel
                                     + the HECLoad gather of repro/cache/hec.py
  hec_search.hec_probe            <- repro/kernels/hec_search.py:hec_search_batched
                                     + the gather of hec_probe and the
                                     response packing of cache_fetch
  update_fused.update_fused_fwd   <- repro/kernels/update_fused.py:fused_update
  update_fused.update_fused_bwd      (its gradient, dZ and db)
  sage_agg.sage_agg_fwd           <- repro/kernels/sage_agg.py:sage_agg
  sage_agg.sage_agg_bwd              (its gradient with respect to h)
  gat_edge.gat_edge_fwd           <- repro/kernels/gat_edge.py:gat_edge
                                     + the gather of ops.gat_edge_aggregate
  gat_edge.gat_edge_bwd              (its gradient, dz, de_u and de_v)
  slot_index.slot_index              the transposed slot index F and H
                                     gather through (torch ops, no kernel)
  sample_draw.sample_draw         <- repro/kernels/sample_draw.py:sample_keys_kernel
                                     + the rest of draw_neighbors_device
"""
