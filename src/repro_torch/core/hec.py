"""Compatibility shim of ``repro/core/hec.py``: the Historical Embedding
Cache lives in ``repro_torch.cache.hec``; every name here is the same
object.  Import from ``repro_torch.cache`` in new code."""
from repro_torch.cache.hec import (HECState, _set_index, hec_init,  # noqa: F401
                                   hec_load, hec_lookup, hec_occupancy,
                                   hec_search, hec_store, hec_tick)

__all__ = ["HECState", "hec_init", "hec_load", "hec_lookup",
           "hec_occupancy", "hec_search", "hec_store", "hec_tick"]
