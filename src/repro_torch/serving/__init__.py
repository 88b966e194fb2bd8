"""Serving stack of the port: ring and paged KV caches, sampler, scheduler,
engine, and the edge/cloud cascade engines over it."""
from repro_torch.serving.engine import (DrainBatchEngine, Request,
                                       ServingEngine, validate_prompt)
from repro_torch.serving.cascade_engine import (CascadeEngine,
                                                CascadeServingEngine,
                                                CircuitBreaker)
from repro_torch.serving.faults import FaultError, FaultPlan, SeamSpec
from repro_torch.serving.kv_cache import (RING, HostSwapHandle, PagedCache,
                                          PagedLayout, RingCache, RingLayout,
                                          make_backend)
from repro_torch.serving.sampler import (accepted_prefix_length, prng_key,
                                         request_keys, sample_logits,
                                         sample_logits_batch,
                                         sample_logits_keyed)
from repro_torch.serving.scheduler import (Scheduler, StepPlan, bucket_for,
                                           prompt_buckets, request_rank)

__all__ = ["ServingEngine", "DrainBatchEngine", "Request", "validate_prompt",
           "CascadeEngine",
           "CascadeServingEngine", "CircuitBreaker", "FaultPlan",
           "FaultError", "SeamSpec", "RING",
           "RingCache", "RingLayout", "PagedCache", "PagedLayout",
           "HostSwapHandle", "make_backend",
           "accepted_prefix_length", "prng_key", "request_keys",
           "sample_logits", "sample_logits_batch", "sample_logits_keyed",
           "Scheduler", "StepPlan", "bucket_for", "prompt_buckets",
           "request_rank"]
