from repro_torch.cache.hec import (EmbeddingCache, HECState,  # noqa: F401
                                   ServeCacheConfig, hec_clone,
                                   hec_init, hec_load, hec_lookup,
                                   hec_occupancy, hec_search, hec_store,
                                   hec_tick)
