from repro_torch.serving.engine import ServeConfig, ServeEngine
from repro_torch.serving.kvcache import (BlockManager, CacheLayout,
                                         PooledKVStore, chain_hashes)
from repro_torch.serving.scheduler import (Request, RequestState,
                                           SamplingParams, Scheduler)

__all__ = ["ServeEngine", "ServeConfig", "Request", "SamplingParams",
           "RequestState", "Scheduler", "BlockManager", "CacheLayout",
           "PooledKVStore", "chain_hashes"]
