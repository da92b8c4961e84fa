"""Data of the port: synthetic corpora and the host pipeline."""
from .pipeline import HostShardedSource, Prefetcher, torch_placer
from .synthetic import MarkovCorpus, lm_batches, mlm_batches

__all__ = ["HostShardedSource", "MarkovCorpus", "Prefetcher",
           "lm_batches", "mlm_batches", "torch_placer"]
