from repro_torch.configs.gnn import (GNNConfig,  # noqa: F401
                                     GRAPHSAGE_PAPERS100M, HECConfig,
                                     PipelineConfig, small_gnn_config)
