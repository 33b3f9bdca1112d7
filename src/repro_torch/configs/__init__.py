from .base import ModelConfig, shape_cells
from .registry import ARCHS, cell_is_runnable, get_config
