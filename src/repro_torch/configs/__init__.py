"""Architecture configs of the port (same schema as ``repro.configs``)."""
from .base import ArchConfig, ShapeSpec, SHAPES, SHAPES_BY_NAME, torch_dtype
from .registry import ASSIGNED_ARCHS, get_config, list_archs
