"""Multi-device solvers: the landmark-sharded BA, the keyframe-block-sharded
essential graph, and the device meshes they run on (torch.distributed)."""
from . import dist_ba  # noqa: F401
from . import dist_pose_graph  # noqa: F401
from . import hostmesh  # noqa: F401
