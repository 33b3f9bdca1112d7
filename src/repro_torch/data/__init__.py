"""`repro_torch.data`: the paper's synthetic bitmap datasets (5.3, 5.4).

The reference's LM data pipeline (``repro.data.pipeline``) needs the model
configurations and waits with the LM substrate (``ROADMAP.md``).
"""
from .paper_datasets import clustered_set, similarity_query, synthetic_dataset, uniform_set

__all__ = ["clustered_set", "similarity_query", "synthetic_dataset", "uniform_set"]
