"""Model zoo of the port (the dense decoder, encoder, ssm and hybrid
families)."""
from .model_zoo import (Model, build_model, draft_config, draft_params,
                        synthetic_batch)

__all__ = ["Model", "build_model", "draft_config", "draft_params",
           "synthetic_batch"]
