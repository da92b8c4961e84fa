"""Model zoo of the port (the dense decoder and encoder families)."""
from .model_zoo import Model, build_model, synthetic_batch

__all__ = ["Model", "build_model", "synthetic_batch"]
