"""Build and run the native C++ reference oracle (native/surforacle.cpp).

The oracle is an independent scalar re-derivation of the reference
pipeline's math: it shares no code with this package, so agreement with
it cross-validates the JAX pipeline.  It is compiled with g++ from the
committed source into the gitignored `native/surforacle` on first use.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
SOURCE = os.path.join(_NATIVE, "surforacle.cpp")
BINARY = os.path.join(_NATIVE, "surforacle")


def build_oracle() -> str:
    """Compile the oracle if it is missing or older than its source and
    return the binary's path.  Raises (OSError / CalledProcessError)
    when no C++ toolchain can build it."""
    if os.path.exists(BINARY) and (
            os.path.getmtime(BINARY) >= os.path.getmtime(SOURCE)):
        return BINARY
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", BINARY, SOURCE],
                   check=True, capture_output=True, timeout=300)
    return BINARY


def run_oracle(image_path: str, *flags: str):
    """-> (keypoints (n, 7) [x, y, scale, strength, laplace, octave,
    ori], descriptors (n, nfeatures)) for one PGM image."""
    out = subprocess.run([BINARY, image_path, *flags], capture_output=True,
                         text=True, check=True, timeout=600).stdout
    lines = out.splitlines()
    n, nf = map(int, lines[0].split())
    kp = np.array([[float(v) for v in lines[1 + i].split()]
                   for i in range(n)]).reshape(n, -1)
    desc = np.array([[float(v) for v in lines[1 + n + i].split()]
                     for i in range(n)]).reshape(n, nf)
    return kp, desc
