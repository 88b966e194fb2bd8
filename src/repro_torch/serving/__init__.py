"""Serving stack of the port: ring and paged KV caches, sampler, scheduler,
engine, the edge/cloud cascade engines over it, and the service layer in
front (fault injection, snapshots, the request journal, the async
gateway), on one device or tensor-parallel on a mesh (``sharding``)."""
from repro_torch.serving.engine import (DrainBatchEngine, Request,
                                       ServingEngine, load_snapshot,
                                       save_snapshot, validate_prompt)
from repro_torch.serving.cascade_engine import (CascadeEngine,
                                                CascadeServingEngine,
                                                CircuitBreaker)
from repro_torch.serving.faults import FaultError, FaultPlan, SeamSpec
from repro_torch.serving.gateway import (BACKPRESSURE_POLICIES,
                                        EngineWedgedError, MeshLeader,
                                        RequestHandle, ServingGateway, follow,
                                        recover_engine)
from repro_torch.serving.journal import RequestJournal
from repro_torch.serving.kv_cache import (RING, HostSwapHandle, PagedCache,
                                          PagedLayout, RingCache, RingLayout,
                                          make_backend)
from repro_torch.serving.sampler import (accepted_prefix_length, prng_key,
                                         request_keys, sample_logits,
                                         sample_logits_batch,
                                         sample_logits_keyed)
from repro_torch.serving.scheduler import (Scheduler, StepPlan, bucket_for,
                                           prompt_buckets, request_rank,
                                           slots_for_hbm)
from repro_torch.serving.sharding import cache_pspecs, place_params

__all__ = ["ServingEngine", "DrainBatchEngine", "Request", "validate_prompt",
           "save_snapshot", "load_snapshot", "ServingGateway",
           "RequestHandle", "EngineWedgedError", "recover_engine",
           "BACKPRESSURE_POLICIES", "RequestJournal",
           "CascadeEngine",
           "CascadeServingEngine", "CircuitBreaker", "FaultPlan",
           "FaultError", "SeamSpec", "RING",
           "RingCache", "RingLayout", "PagedCache", "PagedLayout",
           "HostSwapHandle", "make_backend",
           "accepted_prefix_length", "prng_key", "request_keys",
           "sample_logits", "sample_logits_batch", "sample_logits_keyed",
           "Scheduler", "StepPlan", "bucket_for", "prompt_buckets",
           "request_rank", "slots_for_hbm", "MeshLeader", "follow",
           "cache_pspecs", "place_params"]
