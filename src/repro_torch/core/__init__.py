"""The PMRF engine and its substrate: data-parallel primitives, the
oversegmentation, synthetic data and evaluation metrics."""
