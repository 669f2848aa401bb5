"""Static configuration for the SURF frontend.

This is the JAX analogue of the reference's three-tier flag system
(CLI args -> `SurfParam` struct -> device `__constant__` mirror; see the
reference's surf_structures.h:44-72 and surf.cpp:60-91).  Nothing is
uploaded: the config is a frozen, hashable dataclass that jitted
functions close over, so every derived parameter becomes an XLA
compile-time constant (the natural analogue of `__constant__` state).

All derivations mirror Surfor::init (surf.cpp:67-79) exactly.
"""

from __future__ import annotations

import dataclasses
import functools
import math

# Compile-time constants of the reference (surfd.h:9-16).
MAX_SCALE = 8
MAX_OCTAVE = 8
NBIN = 72                       # orientation histogram bins
WINDOW = 1.0471975511965976     # pi / 3 sliding orientation window
SEP_ANGLE = 0.08726646259971647  # 2*pi / NBIN
HWN = 6                         # half window size in bins
ORADIUS = 9                     # orientation sampling disc radius (in steps)
ORADIUS_SQ = 81.5


@dataclasses.dataclass(frozen=True)
class SurfConfig:
    """User-facing SURF parameters plus all derived quantities.

    Defaults follow the reference demo (main.cpp:187-204): 4 octaves,
    threshold 4.0, no image doubling, initial 9x9 mask, sampling step 2,
    upright descriptors, 64-d.
    """

    noctaves: int = 4
    thresh: float = 4.0
    doubled: bool = False
    init_mask_size: int = 9
    sampling_step: int = 2
    upright: bool = True
    extended: bool = False
    desc_wsz: int = 4
    max_pts: int = 10000
    # Static capacity knobs (no CUDA counterpart: the reference uses
    # atomicInc append; XLA needs static shapes so detection compacts
    # through fixed-size candidate buffers).
    candidates_per_octave: int = 4096
    interp_moves: int = 5
    # Subpixel-fit backend: "dense" solves the quadratic fit at every
    # pyramid position (4-value maps, walk gathers 4 floats/candidate);
    # "sparse" gathers the 19 stencil neighbours per candidate and
    # solves only there (no per-position maps/writes).  Numerically
    # identical; a hardware A/B knob (ops/extrema.py).
    detect_fit: str = "dense"

    @property
    def max_candidates(self) -> int:
        """Global pre-interpolation candidate capacity (the analogue of
        the reference's unbounded in-kernel cell pass; interpolated
        survivors are then compacted to max_pts)."""
        return 2 * self.max_pts

    # ---- derived parameters (Surfor::init, surf.cpp:67-79) ----

    @property
    def divisor(self) -> float:
        return 0.5 if self.doubled else 1.0

    @property
    def init_lobe(self) -> int:
        return self.init_mask_size // 3

    @property
    def max_scale(self) -> int:
        return self.init_lobe + 2

    @property
    def sampling(self) -> int:
        return self.sampling_step * (2 if self.doubled else 1)

    @property
    def mag_factor(self) -> int:
        return 12 // self.desc_wsz

    @property
    def orient_size(self) -> int:
        return 8 if self.extended else 4

    @property
    def nfeatures(self) -> int:
        return self.desc_wsz * self.desc_wsz * self.orient_size

    # ---- descriptor geometry bounds (static shapes for XLA) ----

    def _desc_geometry(self, scale: float) -> tuple[int, int, int]:
        """(step, iscale, iradius) for a given keypoint scale (describeUR*,
        surfd.cu:1373-1387; rotated x1.4 at surfd.cu:2428)."""
        work = (3.3 if self.doubled else 1.65) * scale
        step = max(1, _round_half_even(work * 0.5))
        iscale = int(work)
        spacing = work * self.mag_factor
        rad = (1.0 if self.upright else 1.4) * spacing * (self.desc_wsz + 1) * 0.5
        return step, iscale, _round_half_even(rad / step)

    @functools.cached_property
    def _max_scale_value(self) -> float:
        """Upper bound on emitted keypoint scales: makePoint gives
        1.2 * ns * divisor (surfd.cu:1004-1006) with ns bounded by the last
        octave's top scale plus the +/-1.5 interpolation offset."""
        octave = 1 << (self.noctaves - 1)
        ns = (self.init_lobe + (octave - 1) * self.max_scale
              + (self.max_scale + 0.5) * 2.0 * octave) / 3.0
        return 1.2 * ns * self.divisor + 1.0

    @functools.cached_property
    def max_iradius(self) -> int:
        """Max descriptor iradius over the reachable scale range.

        The reference computes a global max via atomicMax (updateIradius,
        surfd.cu:991-998) then sizes the describe grid by device readback
        (surfd.cu:3267-3279).  Shapes here must be static, so the radius
        is bounded over the full reachable scale range instead.
        """
        best = 0
        s = 0.5
        while s < self._max_scale_value:
            best = max(best, self._desc_geometry(s)[2])
            s += 0.01
        return best

    @property
    def desc_grid(self) -> int:
        """Static side length of the descriptor sampling grid."""
        return 2 * self.max_iradius + 1

    # ---- image-geometry helpers (Surfor::allocMemory, surf.cpp:374-392) ----

    def integral_shape(self, h: int, w: int) -> tuple[int, int]:
        if self.doubled:
            return (h + h - 1, w + w - 1)
        return (h + 1, w + 1)

    def octave_shapes(self, h: int, w: int) -> list[tuple[int, int]]:
        ih, iw = self.integral_shape(h, w)
        shapes = [((ih - 1) // self.sampling, (iw - 1) // self.sampling)]
        for _ in range(1, self.noctaves):
            ph, pw = shapes[-1]
            shapes.append((ph >> 1, pw >> 1))
        return shapes

    def hessian_schedule(self, h: int, w: int) -> list["OctaveSchedule"]:
        """Host-side per-octave scale parameters.

        Mirrors the interleaved updates of Surfor::detectAndCompute
        (surf.cpp:240-294) and cuCalcHessianMulti (surfd.cu:2844-2865):
        `mask_size` carries across octaves, `border1` is threaded through the
        scale loop, and `borders[s]` records the pre-update value used by the
        NMS/interp stage.
        """
        schedules = []
        mask_size = self.init_lobe - 2
        octave = 1
        for o in range(self.noctaves):
            if o > 0:
                border1 = ((3 * (mask_size + 4 * octave)) // 2) // (self.sampling * octave) + 1
                borders = [border1, border1] + [0] * (self.max_scale - 2)
                init_scale = 2
            else:
                border1 = ((3 * (mask_size + 6 * octave)) // 2) // (self.sampling * octave) + 1
                borders = [0] * self.max_scale
                init_scale = 0
            scales = []
            for i, s in enumerate(range(init_scale, self.max_scale)):
                borders[s] = border1
                delta = self.sampling * octave
                msz = mask_size + 2 * octave * (i + 1)
                if s > 2:
                    border1 = 3 * msz // 2 // delta + 1
                norm = (9.0 / float(msz * msz)) ** 2
                scales.append(ScaleParams(
                    scale_index=s, mask_size=msz, border1=border1,
                    border2=delta * border1, delta=delta, norm=norm,
                    x2=msz // 2, x3=2 * (msz // 2), x4=3 * (msz // 2),
                ))
            mask_size = scales[-1].mask_size
            schedules.append(OctaveSchedule(
                octave=octave, init_scale=init_scale, scales=tuple(scales),
                borders=tuple(borders),
            ))
            octave += octave
        return schedules


@dataclasses.dataclass(frozen=True)
class ScaleParams:
    """Per-scale box-filter geometry (hessian_params rows, surfd.cu:2846-2859)."""
    scale_index: int
    mask_size: int
    border1: int
    border2: int
    delta: int
    norm: float
    x2: int
    x3: int
    x4: int


@dataclasses.dataclass(frozen=True)
class OctaveSchedule:
    octave: int          # 1, 2, 4, 8, ...
    init_scale: int      # 0 for octave 0, else 2 (scales 0-1 seeded by decimation)
    scales: tuple[ScaleParams, ...]
    borders: tuple[int, ...]  # NMS/interp borders per scale (surf.cpp:261-269)

    def maximum_borders(self) -> list[int]:
        """Extrema-cell borders per scale pair (cuFindMaximumWithInterp,
        surfd.cu:3062-3071): mborders[z] = borders[2z+2] + 1."""
        out = []
        max_scale = len(self.borders)
        for k in range(1, max_scale - 1, 2):
            out.append(self.borders[k + 1] + 1)
        return out


def _round_half_even(x: float) -> int:
    """CUDA __float2int_rn: round to nearest, ties to even."""
    f = math.floor(x)
    d = x - f
    if d > 0.5:
        return f + 1
    if d < 0.5:
        return f
    return f + (f % 2)


def lut1() -> list[float]:
    """Orientation Gaussian weight LUT (Surfor::initLut, surf.cpp:360-364)."""
    return [math.exp(-(n + 0.5) / 12.5) for n in range(83)]


def lut2() -> list[float]:
    """Descriptor Gaussian weight LUT (surf.cpp:366-370)."""
    return [math.exp(-(n + 0.5) / 8.0) for n in range(40)]


def bin_centers() -> list[float]:
    """72 histogram bin lower edges -pi..pi (surf.cpp:85-89)."""
    out = [-math.pi]
    for _ in range(1, NBIN):
        out.append(out[-1] + SEP_ANGLE)
    return out
