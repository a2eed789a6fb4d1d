"""Configuration for the block-matching motion-estimation engine.

The reference program hardwires every parameter in source (search/block sizes and
level count at ``main_class.cpp:19-21``, interpolation factor at ``:32-33``, the
regularization schedule at ``motion_framework.cpp:141-152``).  Here they are a
first-class frozen dataclass so configs hash cleanly into ``jax.jit`` static
arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

CostKind = Literal["sad", "ssd", "zsad"]
RegularizerMode = Literal["exact", "fourcolor", "jacobi", "windowed"]
SearchImpl = Literal["auto", "xla", "triton", "triton_interpret"]
SearchOrder = Literal["spiral", "raster"]


@dataclasses.dataclass(frozen=True)
class MotionConfig:
    """Full configuration of the coarse-to-fine block-matching pipeline.

    Defaults replicate the reference's shipped Middlebury configuration
    (``main_class.cpp:19-21``): 4 pyramid levels, 32x32 blocks, 64px search
    windows, 4x pre-interpolation for quarter-pel output.

    Attributes:
      block_sizes: per-level block edge (level 0 = finest). Powers of two >= 2.
      search_sizes: per-level search window edge; ``shift = search - block``
        defines the spiral extent (``motion_framework.cpp:299``).
      interp_factor: integer pre-upsampling factor applied to both frames before
        estimation; output MVs are divided back down (``main_class.cpp:32-70``).
      cost: matching cost. ``sad`` is the reference's ``cv::norm(NORM_L1)``;
        ``ssd`` is the sum of squared differences; ``zsad`` is zero-mean
        SAD (sum |d - mean(d)| per block) - invariant to uniform brightness
        offsets and first-order robust to gain, the classical fix for raw
        SAD's collapse under photometric nuisance (EVAL_robust.md).  zsad
        is float-valued and runs on the XLA cost paths (the cost-volume
        kernel implements sad/ssd); the default stays reference-faithful
        raw SAD (``motion_framework.cpp:315``).
      regularizer: sweep scheduling for the 8-connected smoothness pass.
        ``exact``     - wavefront Gauss-Seidel, bit-exact with the reference's
                        in-place raster sweeps (``motion_framework.cpp:616``).
        ``fourcolor`` - 4-color Gauss-Seidel (parallel within a color); fast,
                        near-identical quality, NOT bit-exact.
        ``jacobi``    - fully parallel sweeps reading the previous iterate.
        ``windowed``  - fourcolor ordering evaluated on per-parent search
                        windows with candidate deltas bounded by reg_radius;
                        the production path (no per-candidate block
                        gathers).  Bit-identical to fourcolor whenever no
                        candidate delta exceeds the radius.
      sweeps_per_round: regularization sweeps per block-subdivision round; the
        reference does 2 with lambda_multiplier = sweep_index + 1
        (``motion_framework.cpp:143-146``).
      lambda_scale: initial lambda = block_size * lambda_scale
        (reference: block_size / 2, ``motion_framework.cpp:73``), doubled on
        each subdivision (``:151``).
      search_impl: cost-volume backend of the windowed levels - ``auto``
        picks the ``triton`` kernel (``kernels.cost_volume``) wherever the
        program is compiled for a GPU and the ``xla`` scan elsewhere; ``triton_interpret`` runs the kernel
        through the Pallas interpreter (CPU tests).  ``triton`` without a
        GPU is an error.  zsad always runs on ``xla``.
      reg_radius: max |candidate delta| from the parent search MV in
        ``windowed`` mode; None means the level's spiral extent S.
      search_order: ``spiral`` is the reference's live path
        (``motion_framework.cpp:296-422``); ``raster`` is its exhaustive
        variant with the closest-to-source tie-break (``:246-294``).
      mv_cap: optional per-component cap on the MV predictions transferred
        between pyramid levels (applied identically in the untiled and tiled
        engines, so tiled == untiled stays bit-exact WITHIN the capped
        model).  Without it the worst-case MV bound compounds per level
        (M_l = 2*M_{l+1} + S_l, 240+ rows at the shipped config), making
        row-tile halos larger than 1080p/8-way tiles so every level falls
        back to replicated execution; with a cap the halo is
        ~cap + 2*S_l rows and level 0 shards at 1080p.  Choose it above the
        true motion range at the processed resolution (like a codec's search
        range); None (default) preserves the uncapped reference model.
      rival_window: ``windowed`` mode only.  Gather a SECOND frame-2 window
        per parent, centered on its most-different 8-neighbor search MV, and
        evaluate candidates outside the primary window against it.  Closes
        the windowed-vs-fourcolor accuracy gap at motion discontinuities
        (where a neighbor's correct MV exceeds the primary radius R and
        could otherwise never be adopted) at the cost of a second window
        gather + cost volume.  See ``ops.windowed`` module docstring.
      rival_radius: max |candidate delta| from the rival center (None: the
        level's primary radius R).  The rival cost volume scales with
        (2*rival_radius+1)^2, so a reduced radius buys back most of the
        rival throughput tax; adopted-from-rival MVs then stay within
        rival_center +- rival_radius.  A PER-LEVEL tuple (level 0 =
        finest; entries int or None) sets the radius per pyramid level:
        coarse levels have few parents, so full radius there is nearly
        free and recovers most of the large-motion accuracy that a
        single truncated radius loses (EVAL_full.md Urban2/Urban3) while
        the fine levels keep the cheap radius.  A tuple shorter than the
        pyramid repeats its LAST entry for the deeper levels (so the
        4-level default applies sensibly to other level counts).  The
        shipped default ``(12, None, 8, 8)`` is the measured accuracy
        knee (EVAL_full.md: mean gap to unrestricted evaluation 0.0087,
        worst-sequence 0.0317): the large-motion accuracy lives at LEVEL 1
        (full radius there), levels 2/3 are accuracy-neutral (so they
        keep radius 8), and a small level-0 bump to 12 buys the rest.
      window_center: ``windowed`` mode only.  ``pred`` (default) centers the
        per-parent windows on the truncated prediction - the spiral search's
        own center (``motion_framework.cpp:233-234``) - so ONE pooled
        cost-volume pass serves both the search argmin and every
        regularization round (the fused fast path; candidates are evaluable
        iff they land in the prediction window).  ``search`` centers them on
        the search winner (two cost volumes per level; candidates bounded by
        ``reg_radius`` around the winner).  The fused path requires
        ``search_order="spiral"`` and default ``reg_radius``; other settings
        fall back to ``search`` centering.
    """

    block_sizes: tuple[int, ...] = (32, 32, 32, 32)
    search_sizes: tuple[int, ...] = (64, 64, 64, 64)
    interp_factor: int = 4
    cost: CostKind = "sad"
    # the production default IS what bench.py and the README run: windowed
    # scheduling with per-level rival windows (mean-EPE gap to unrestricted
    # fourcolor evaluation 0.0087, EVAL_full.md).  The reference-faithful
    # schedules remain one flag away (regularizer="exact"/"fourcolor").
    regularizer: RegularizerMode = "windowed"
    sweeps_per_round: int = 2
    lambda_scale: float = 0.5
    search_impl: SearchImpl = "auto"
    search_order: SearchOrder = "spiral"
    reg_radius: int | None = None
    window_center: Literal["pred", "search"] = "pred"
    rival_window: bool = True
    rival_radius: int | tuple[int | None, ...] | None = (12, None, 8, 8)
    mv_cap: int | None = None

    def __post_init__(self) -> None:
        if len(self.block_sizes) != len(self.search_sizes):
            raise ValueError(
                "block_sizes and search_sizes must have the same length, got "
                f"{len(self.block_sizes)} vs {len(self.search_sizes)}"
            )
        if not self.block_sizes:
            raise ValueError("need at least one pyramid level")
        for bs, ss in zip(self.block_sizes, self.search_sizes):
            if bs < 2 or bs & (bs - 1):
                raise ValueError(f"block size must be a power of two >= 2, got {bs}")
            if ss < bs:
                raise ValueError(f"search size {ss} must be >= block size {bs}")
        if self.interp_factor < 1:
            raise ValueError("interp_factor must be >= 1")
        if isinstance(self.rival_radius, tuple):
            if not self.rival_radius:
                raise ValueError("per-level rival_radius tuple cannot be empty")
            for r in self.rival_radius:
                if r is not None and r < 0:
                    raise ValueError("rival_radius entries must be >= 0 or None")
        elif self.rival_radius is not None and self.rival_radius < 0:
            raise ValueError("rival_radius must be >= 0")
        if self.cost == "zsad" and self.search_impl in (
            "triton", "triton_interpret"
        ):
            raise ValueError(
                "the cost-volume kernel implements sad/ssd; zsad runs on "
                "search_impl='xla' or 'auto'"
            )
        if self.mv_cap is not None and self.mv_cap < max(
            ss - bs for bs, ss in zip(self.block_sizes, self.search_sizes)
        ):
            raise ValueError(
                "mv_cap below the largest search shift would forbid MVs the "
                f"coarsest search itself produces, got {self.mv_cap}"
            )

    @property
    def num_levels(self) -> int:
        return len(self.block_sizes)

    @property
    def uses_fused_windowed(self) -> bool:
        """True when levels run the fused one-cost-volume windowed path."""
        return (
            self.regularizer == "windowed"
            and self.window_center == "pred"
            and self.search_order == "spiral"
            and self.reg_radius is None
        )

    def shift(self, level: int) -> int:
        """Search extent: reference ``shift = search_size - block_size``."""
        return self.search_sizes[level] - self.block_sizes[level]

    def rival_radius_at(self, level: int) -> int | None:
        """Rival radius for one pyramid level (level 0 = finest): the scalar
        setting everywhere, or the level's entry of a per-level tuple."""
        if isinstance(self.rival_radius, tuple):
            # last entry extends to deeper levels (see class docstring)
            return self.rival_radius[min(level, len(self.rival_radius) - 1)]
        return self.rival_radius

    def replace(self, **kw) -> "MotionConfig":
        return dataclasses.replace(self, **kw)


def middlebury_config(**overrides) -> MotionConfig:
    """The reference's shipped configuration (``main_class.cpp:19-21``)."""
    return MotionConfig(**overrides)


def tiny_config(
    block_sizes: Sequence[int] = (8, 8),
    search_sizes: Sequence[int] = (16, 16),
    **overrides,
) -> MotionConfig:
    """Small config for unit tests and CPU smoke runs."""
    overrides.setdefault("interp_factor", 1)
    return MotionConfig(
        block_sizes=tuple(block_sizes),
        search_sizes=tuple(search_sizes),
        **overrides,
    )
