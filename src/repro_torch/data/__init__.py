"""Synthetic data substrate (numpy only, shared byte-for-byte with the JAX
package's copy) and the streaming data plane (``pipeline``)."""
from repro_torch.data.pipeline import (DeferredMetrics, DeviceSlab,
                                       PrefetchError, Prefetcher,
                                       SlabStager, staging_signature)
from repro_torch.data.synthetic import TabularTask, TokenTask, lm_batch

__all__ = ["TabularTask", "TokenTask", "lm_batch",
           "Prefetcher", "PrefetchError", "DeferredMetrics",
           "staging_signature", "SlabStager", "DeviceSlab"]
