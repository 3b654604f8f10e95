from repro_torch.configs.gnn import (GNNConfig,  # noqa: F401
                                     GRAPHSAGE_PAPERS100M, small_gnn_config)
