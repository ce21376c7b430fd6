"""Host milliseconds of FLAME at the timestep, the face frames and the
binding chain (`models/flame.py`, `models/flame_gaussians.py`,
`models/gaussians.py::world_space_gaussians`) in a train step."""

from avatarbench.measures import flame_binding_ms

read = flame_binding_ms
