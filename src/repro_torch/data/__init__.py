"""Synthetic training data, held against ``repro/data``."""
from repro_torch.data.pipeline import SyntheticDataset, make_batch  # noqa: F401
