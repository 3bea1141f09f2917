from . import config, layers, model  # noqa: F401
from .config import SHAPES, ModelConfig, ShapeSpec  # noqa: F401
