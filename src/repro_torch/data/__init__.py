"""`repro_torch.data`: the paper's synthetic bitmap datasets (5.3, 5.4) and
the LM data pipeline."""
from .paper_datasets import clustered_set, similarity_query, synthetic_dataset, uniform_set
from .pipeline import DataConfig, arch_batch, lm_batch, lm_batches

__all__ = ["clustered_set", "similarity_query", "synthetic_dataset", "uniform_set",
           "DataConfig", "arch_batch", "lm_batch", "lm_batches"]
