from .shapes import (ALL_SHAPES, DECODE_32K, LONG_500K,  # noqa: F401
                     PREFILL_32K, TRAIN_4K, ShapeSpec, shape_by_name)
from .registry import (ARCHS, cells, get_config, reduced_config,  # noqa: F401
                       skip_reason)
