"""Model zoo of the port: the dense and MoE decoders (MLA included), the
encoder, the encoder-decoder, the VLM, and the ssm and hybrid families."""
from .model_zoo import (Model, build_model, draft_config, draft_params,
                        synthetic_batch)

__all__ = ["Model", "build_model", "draft_config", "draft_params",
           "synthetic_batch"]
