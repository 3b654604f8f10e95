from repro_torch.serve.gnn.embedding_cache import (  # noqa: F401
    ServeCacheConfig, ServingCache)
from repro_torch.serve.gnn.offline import (direct_forward,  # noqa: F401
                                           full_neighbor_matrix,
                                           layerwise_embeddings,
                                           serve_layer_dims, warm_cache)
from repro_torch.serve.gnn.prewarm import (degree_weighted_vids,  # noqa: F401
                                           prewarm, query_log_vids,
                                           select_prewarm_vids)
from repro_torch.serve.gnn.scheduler import (AdmissionRejected,  # noqa: F401
                                             GNNRequest, GNNServeConfig,
                                             GNNServeScheduler, ServeFrontend)
