"""The collective layer of the port: lowered permute programs and the tree
collectives that run them over a process group (`P2P`) or over ranks stacked
on one device (`Stacked`)."""
from .executor import (PermuteCall, PermuteProgram,  # noqa: F401
                       compile_program)
from .collectives import (P2P, Stacked, tree_all_gather,  # noqa: F401
                          tree_all_reduce, tree_all_reduce_multi,
                          tree_all_to_all, tree_broadcast, tree_reduce,
                          tree_reduce_scatter)
from .mesh_axes import AxisSchedules, CollectiveContext  # noqa: F401
from .overlap import (BucketedAllReduce, compressed_all_reduce,  # noqa: F401
                      partition_buckets)
