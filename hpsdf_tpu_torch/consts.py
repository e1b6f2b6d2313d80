"""Global constants for the hp-adaptive SDF octree.

A copy of ``hpsdf_tpu/consts.py`` (the reference library's compile-time
constants, Include/HP/Consts.h:7-8, Include/Utility/Literals.h:13-14).
"""

# Maximum polynomial total degree a node basis may reach.
# (reference: Include/HP/Consts.h:7  BASIS_MAX_DEGREE = 12)
BASIS_MAX_DEGREE = 12

# Maximum octree depth (root = depth 0).
# (reference: Include/HP/Consts.h:8  TREE_MAX_DEPTH = 10)
TREE_MAX_DEPTH = 10

# Depth/degree of the initial uniform refinement pass.
# (reference: Source/HP/Octree.cpp:115-116)
COARSE_DEPTH = 4
COARSE_DEGREE = 2

# Error assigned to freshly created coarse nodes so they are refined first.
# (reference: Include/HP/Octree.h:89  INITIAL_NODE_ERR = 100.0)
INITIAL_NODE_ERR = 100.0

# f32 epsilon used for sparse-entry pruning and CG tolerance.
# (reference: Include/Utility/Literals.h:14  EPSILON_F32 = 1e-6)
EPSILON_F32 = 1e-6


def coeff_count(degree: int) -> int:
    """Number of coefficients in a 3-D total-degree-``degree`` basis.

    (n+1)(n+2)(n+3)/6 -- 455 at degree 12.
    (reference: Include/HP/Utility.h:87-106  LegendreCoeffientCount)
    """
    return (degree + 1) * (degree + 2) * (degree + 3) // 6


# Interior (non-leaf) nodes carry no basis; mirrors the reference's
# ``degree == BASIS_MAX_DEGREE + 1`` sentinel (Source/HP/Node.cpp:7-14)
# but we use -1 in the flat SoA arrays.
NO_BASIS = -1
NO_CHILD = -1
