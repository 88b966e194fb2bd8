"""Serving stack of the port: ring and paged KV caches, sampler, scheduler,
engine."""
from repro_torch.serving.engine import Request, ServingEngine, validate_prompt
from repro_torch.serving.kv_cache import (RING, HostSwapHandle, PagedCache,
                                          PagedLayout, RingCache, RingLayout,
                                          make_backend)
from repro_torch.serving.sampler import (accepted_prefix_length, request_keys,
                                         sample_logits_keyed)
from repro_torch.serving.scheduler import (Scheduler, StepPlan, bucket_for,
                                           prompt_buckets, request_rank)

__all__ = ["ServingEngine", "Request", "validate_prompt", "RING",
           "RingCache", "RingLayout", "PagedCache", "PagedLayout",
           "HostSwapHandle", "make_backend",
           "accepted_prefix_length", "request_keys", "sample_logits_keyed",
           "Scheduler", "StepPlan", "bucket_for", "prompt_buckets",
           "request_rank"]
