"""Topology spec grammar and zoo: a copy of src/repro/topo (the TPU
roofline constants left out: the card's are `hardware.H100_SXM`), so spec
strings resolve alike in both packages."""
from .spec import (  # noqa: F401
    TopologySpec, TopologySpecError, TransformSpec, register_topology,
    register_transform, resolve_topology, topology_families,
    transform_names, zoo_specs,
)
from .zoo import (  # noqa: F401
    ZOO_SPECS,
    ring, bidir_ring, line, fully_connected, torus_2d, torus_3d,
    hypercube, star_switch, circulant, two_cluster_switch, fig1a,
    fig1d_ring_unwound,
    fat_tree, dragonfly, dgx_box, bcube, mesh_of_dgx,
    fail_link, degrade_link,
)
from .tpu import (  # noqa: F401
    v5e_pod_topology, multipod_topology, axis_topology_for_mesh,
)
from .hardware import H100_SXM, HardwareSpec  # noqa: F401
