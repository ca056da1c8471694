# The paper's primary contribution: a strongly polynomial-time compiler from
# arbitrary switched network topologies to bandwidth-optimal pipelined
# collective schedules (allgather / reduce-scatter / allreduce / broadcast /
# alltoall).
from .graph import DiGraph, Edge, validate_eulerian  # noqa: F401
from .maxflow import FlowNetwork, build_network, build_Dk  # noqa: F401
from .optimality import (Optimality, allgather_inv_xstar,  # noqa: F401
                         brute_force_inv_xstar, choose_U_k, oracle_feasible,
                         simplest_between, solve_optimality)
from .edge_split import (EdgeSplitError, SplitResult,  # noqa: F401
                         expand_paths, max_discard_capacity,
                         max_split_capacity, max_split_capacity_rooted,
                         remove_switches, remove_switches_rooted,
                         trivial_split)
from .arborescence import (PackingError, TreeClass,  # noqa: F401
                           max_tree_depth, pack_arborescences,
                           pack_rooted_trees, verify_packing,
                           verify_rooted_packing)
from .fixed_k import FixedKResult, fixed_k_feasible, solve_fixed_k  # noqa: F401
from .lower_bounds import (allgather_lb, allreduce_lb, alltoall_lb,  # noqa: F401
                           broadcast_lb,
                           broadcast_root_lb, brute_force_bottleneck_cut,
                           min_compute_separating_cut,
                           re_bc_allreduce_runtime, reduce_lb, reduce_root_lb,
                           rs_ag_allreduce_runtime, single_node_cut,
                           theorem19_rs_ag_optimal)
from .schedule import (AllReduceSchedule, PipelineSchedule, Send,  # noqa: F401
                       broadcast_lambda, compile_allgather, compile_allreduce,
                       compile_alltoall, compile_broadcast, compile_reduce,
                       compile_reduce_scatter)
from .plan import (CollectivePlan, CompileStats, PlanError,  # noqa: F401
                   StageStat, compile_family, compile_plan, plan_for)
from .simulate import (ScheduleError, SimReport, cut_traffic,  # noqa: F401
                       simulate_allgather, simulate_allreduce,
                       simulate_alltoall, simulate_broadcast, simulate_reduce,
                       simulate_reduce_scatter, verify_allgather_delivery,
                       verify_alltoall_delivery,
                       verify_broadcast_delivery, verify_reduce,
                       verify_reduce_scatter)
