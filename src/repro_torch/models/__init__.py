"""Model zoo of the port (dense decoder family)."""
from .model_zoo import Model, build_model, synthetic_batch

__all__ = ["Model", "build_model", "synthetic_batch"]
