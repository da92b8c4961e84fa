"""Architecture configs of the port (same schema as ``repro.configs``)."""
from .base import ArchConfig, ShapeSpec, torch_dtype
from .registry import get_config
