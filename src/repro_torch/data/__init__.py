"""The port's synthetic data pipeline (``repro.data`` counterpart)."""
from repro_torch.data.pipeline import synthetic_batch, synthetic_stream

__all__ = ["synthetic_batch", "synthetic_stream"]
