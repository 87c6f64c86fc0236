"""Render settings (mirror of Pathtracer.h:51-105, ToneMapper config,
Renderer::RenderSettings — Renderer.h:30-39).

Settings split into a *static* part (hashable; jit specializes on it, the
analogue of the reference's flag-driven shader behavior) and a *dynamic*
part (traced scalars — sliders that must not trigger recompilation).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import numpy as np

# Debug outputs (PathTracer.lib.hlsl:43-72).
DEBUG_NONE = 0
DEBUG_HIT_KIND = 1
DEBUG_VERTEX_COLOR = 2
DEBUG_VERTEX_ALPHA = 3
DEBUG_VERTEX_NORMAL = 4
DEBUG_VERTEX_TANGENT = 5
DEBUG_VERTEX_BITANGENT = 6
DEBUG_TEXCOORD_0 = 7
DEBUG_TEXCOORD_1 = 8
DEBUG_COLOR = 9
DEBUG_ALPHA = 10
DEBUG_SHADING_NORMAL = 11
DEBUG_SHADING_TANGENT = 12
DEBUG_SHADING_BITANGENT = 13
DEBUG_METALNESS = 14
DEBUG_ROUGHNESS = 15
DEBUG_SPECULAR = 16
DEBUG_SPECULAR_COLOR = 17
DEBUG_CLEARCOAT = 18
DEBUG_CLEARCOAT_ROUGHNESS = 19
DEBUG_CLEARCOAT_NORMAL = 20
DEBUG_TRANSMISSIVE = 21
DEBUG_BOUNCE_DIRECTION = 22
DEBUG_BOUNCE_BSDF = 23
DEBUG_BOUNCE_PDF = 24
DEBUG_BOUNCE_WEIGHT = 25
DEBUG_BOUNCE_IS_TRANSMISSION = 26
DEBUG_HEMISPHERE_VIEW_SIDE = 27

MAX_BOUNCES_HARD_CAP = 5  # Pathtracer.h:102

TONEMAPPER_NONE = 0
TONEMAPPER_AGX = 1


@dataclasses.dataclass(frozen=True)
class PathTracerSettings:
    """Static flags + bounce counts (Pathtracer.h:51-105 defaults from
    Main.cpp:455-474). Hashable -> usable as a jit static argument."""

    cull_backface: bool = False
    accumulate: bool = True
    # Pathtracer.h:78-79 / Main.cpp:302: seed every accumulation pass by the
    # frame counter (default), or pin the per-pass seed to `fixed_seed`.
    use_frame_as_seed: bool = True
    luminance_clamp_enabled: bool = True
    indirect_environment_only: bool = False
    point_lights: bool = True
    shadow_rays: bool = True
    alpha_shadows: bool = True
    environment_map: bool = True
    environment_mis: bool = True
    material_diffuse_white: bool = False
    material_use_geometric_normals: bool = False
    material_mis: bool = True
    show_nan: bool = False
    show_inf: bool = False
    shading_normal_adaptation: bool = True
    min_bounces: int = 2
    max_bounces: int = 2
    debug_output: int = DEBUG_NONE
    max_accumulated_frames: int = 8196  # Main.cpp:474
    # Internal dispatch knob (not a reference setting): when shadows are
    # binary, punctual-light shadow rays ride the merged bounce+env-NEE
    # launch instead of their own any-hit dispatch. Radiance is bit-identical
    # either way (accumulation order preserved); False = the A/B control.
    merged_light_dispatch: bool = True


class PathTracerParams(NamedTuple):
    """Dynamic (traced) scalars. Defaults from Main.cpp:455-474."""

    environment_intensity: Any = 1.0
    # Pathtracer.h:79 `seed`: used when use_frame_as_seed is off. Dynamic
    # (traced) so changing it never recompiles; the reset that the reference's
    # UI triggers on change (Main.cpp:304) is the renderer's reset key.
    fixed_seed: Any = 0
    environment_color: Any = (1.0, 1.0, 1.0)
    luminance_clamp: Any = 20.0
    min_russian_roulette_continue_prob: Any = 0.05
    max_russian_roulette_continue_prob: Any = 0.95
    # Reference quirk kept: Pathtracer.cpp:322 hardcodes 1000 regardless of
    # the settings value.
    max_ray_length: Any = 1000.0


@dataclasses.dataclass(frozen=True)
class ToneMapSettings:
    tonemapper: int = TONEMAPPER_AGX
    exposure: float = 1.0


@dataclasses.dataclass(frozen=True)
class BloomSettings:
    """Rasterizer.h:14-15 defaults: strength 0.01, radius 4."""

    enabled: bool = True
    strength: float = 0.01
    max_mips: int = 4


# Transmission backdrop downsample kernels
# (TransmissionDownsample.cs.hlsl selectable kernels).
TRANSMISSION_KERNEL_PASSTHROUGH = 0
TRANSMISSION_KERNEL_BJORGE = 1
TRANSMISSION_KERNEL_JIMENEZ = 2


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Renderer::RenderSettings (Renderer.h:30-39)."""

    backend: str = "pathtracer"  # or "rasterizer"
    width: int = 1280
    height: int = 720
    pt: PathTracerSettings = dataclasses.field(default_factory=PathTracerSettings)
    tonemap: ToneMapSettings = dataclasses.field(default_factory=ToneMapSettings)
    bloom: BloomSettings = dataclasses.field(default_factory=BloomSettings)
