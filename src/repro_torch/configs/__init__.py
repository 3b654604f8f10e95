from repro_torch.configs.base import (ArchConfig, get_arch,  # noqa: F401
                                      list_archs, register)
from repro_torch.configs.gnn import (GNNConfig,  # noqa: F401
                                     GAT_PAPERS100M, GRAPHSAGE_PAPERS100M,
                                     HECConfig, PipelineConfig,
                                     SamplerConfig, small_gnn_config)
from repro_torch.configs.shapes import (InputShape, SHAPES,  # noqa: F401
                                        get_shape, shape_applicable)
