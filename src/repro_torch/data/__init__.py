"""Data of the port: synthetic corpora and the host pipeline."""
from .pipeline import (HostShardedSource, Prefetcher, device_placer,
                       mesh_placer, torch_placer)
from .synthetic import MarkovCorpus, lm_batches, mlm_batches

__all__ = ["HostShardedSource", "MarkovCorpus", "Prefetcher",
           "device_placer", "lm_batches", "mesh_placer", "mlm_batches",
           "torch_placer"]
