"""cuda_surf_tpu: a JAX feature-SLAM framework for NVIDIA GPUs.

JAX/XLA implementation with the capabilities of the CUDA-SURF reference
(SURF detector + descriptor + brute-force matcher), extended into a
SLAM/SfM engine (RANSAC two-view geometry, Schur-complement bundle
adjustment, pose-graph optimization, distributed BA over a device
mesh).  See SURVEY.md for the structural analysis of the
reference this build targets.
"""

from .config import SurfConfig
from .types import Keypoints, Matches
from .frontend import Surf, detect_and_compute
from .ops.matcher import match_keypoints

__version__ = "0.1.0"

__all__ = [
    "SurfConfig", "Keypoints", "Matches", "Surf",
    "detect_and_compute", "match_keypoints",
]
