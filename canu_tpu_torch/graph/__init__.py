from .best_overlap import BestOverlapGraph, build_unitigs  # noqa: F401
from .orphans import merge_orphans  # noqa: F401
from .repeats import mark_repeats, split_discontinuous  # noqa: F401
