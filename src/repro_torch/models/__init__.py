from .attention import MaskSpec, attend  # noqa: F401
from .common import ModelConfig  # noqa: F401
from .model_zoo import Model, build_model  # noqa: F401
