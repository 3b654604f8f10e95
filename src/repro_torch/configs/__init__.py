from repro_torch.configs.gnn import (GNNConfig,  # noqa: F401
                                     GAT_PAPERS100M, GRAPHSAGE_PAPERS100M,
                                     HECConfig, PipelineConfig,
                                     SamplerConfig, small_gnn_config)
