"""Topology constants of the FLAME 2023 head mesh.

These are *data facts* about the fixed FLAME vertex numbering (5023
vertices), required to reproduce the reference's procedural teeth
augmentation and region masks (reference flame_model/flame.py:186-483,
641-733). Any implementation binding gaussians to the same FLAME topology
must agree on these indices, or saved avatars would not transfer.

Only the tables needed by the core pipeline are kept here; broad cosmetic
regions (half-face splits, eyelids, ...) come from the user-provided
FLAME_masks.pkl at runtime.
"""

import numpy as np

# Ordered outer lip rings (15 vertices each, left-to-right): the anchors the
# teeth rows are extruded from.
LIP_OUTSIDE_RING_UPPER = np.array(
    [1713, 1715, 1716, 1735, 1696, 1694, 1657, 3543, 2774, 2811, 2813, 2850,
     2833, 2832, 2830], np.int64
)
LIP_OUTSIDE_RING_LOWER = np.array(
    [1576, 1577, 1773, 1774, 1795, 1802, 1865, 3503, 2948, 2905, 2898, 2881,
     2880, 2713, 2712], np.int64
)

# Ordered inner lip rings (used by region masks / viewers).
LIP_INSIDE_RING_UPPER = np.array(
    [1595, 1746, 1747, 1742, 1739, 1665, 1666, 3514, 2783, 2782, 2854, 2857,
     2862, 2861, 2731], np.int64
)
LIP_INSIDE_RING_LOWER = np.array(
    [1572, 1573, 1860, 1862, 1830, 1835, 1852, 3497, 2941, 2933, 2930, 2945,
     2943, 2709, 2708], np.int64
)
LIP_INSIDE_RING_EXTRA = np.array([1594, 2730], np.int64)

# Anchor points on the neck boundary (viewer/cluster helpers).
NECK_LEFT_POINT = 3193
NECK_RIGHT_POINT = 3296
FRONT_MIDDLE_BOTTOM_POINT_BOUNDARY = 3285
BACK_MIDDLE_BOTTOM_POINT_BOUNDARY = 3248

NUM_FLAME_VERTS = 5023
NUM_FLAME_FACES = 9976
NUM_TEETH_VERTS = 120
NUM_TEETH_FACES = 168
