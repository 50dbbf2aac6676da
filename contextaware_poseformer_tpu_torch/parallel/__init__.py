from contextaware_poseformer_tpu_torch.parallel import distributed  # noqa: F401
from contextaware_poseformer_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
)
