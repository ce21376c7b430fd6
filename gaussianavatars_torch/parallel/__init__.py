"""Multi-process parallelism: the process mesh and the render-parallel
render and train steps over `torch.distributed` (port of
`gaussianavatars_tpu/parallel`)."""

from gaussianavatars_torch.parallel.mesh import make_mesh
from gaussianavatars_torch.parallel.sharded import (
    make_sharded_render,
    make_sharded_train_step,
)
