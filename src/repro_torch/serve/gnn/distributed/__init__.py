from repro_torch.serve.gnn.distributed.offline import (  # noqa: F401
    exchange_halos, global_neighbor_width, layerwise_embeddings_dist)
from repro_torch.serve.gnn.distributed.router import QueryRouter  # noqa: F401
from repro_torch.serve.gnn.distributed.scheduler import (  # noqa: F401
    DistGNNServeScheduler, DistServeConfig, build_serve_data)
from repro_torch.serve.gnn.distributed.sharded_cache import (  # noqa: F401
    ShardedServingCache)
