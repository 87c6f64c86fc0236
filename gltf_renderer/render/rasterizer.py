"""Raster backend (port of Rasterizer.cpp + ForwardPass.cpp + Forward.vs/ps).

Primary visibility is computed by casting pixel rays
against the scene BVH instead of a z-buffered triangle scan — for opaque
geometry the result is IDENTICAL to a z-buffer (closest surface per pixel),
and ordered alpha blending falls out of depth-sorted hits along the ray
(the reference sorts blended draws back-to-front on the CPU,
Rasterizer.cpp:115-124). Shading is the Forward.ps.hlsl pipeline: IBL from the
GGX-prefiltered + diffuse-convolved cubes with the Pesce/Iwanicki DFG
bias-scale approximation (Forward.ps.hlsl:203-264), anisotropic bent normal,
screen-space transmission through a mip-blurred backdrop
(ForwardPass::GenerateTransmissionMips), clearcoat IBL, analytic punctual
lights with the full layered BSDF (no shadows — raster parity), motion
vectors from the previous frame's world-to-clip.

Pass order mirrors Rasterizer::DrawScene (Rasterizer.cpp:150-288):
opaque+alpha-test -> background -> transmission mips -> transmissive +
alpha-blend (back-to-front) -> bloom (in renderer) -> tonemap.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from gltf_renderer.ops import bvh as bvh_ops
from gltf_renderer.ops.bsdf import fresnel_coat, gltf_bsdf, modulate_roughness
from gltf_renderer.ops.lights import get_light_ray
from gltf_renderer.ops.material import get_surface_properties
from gltf_renderer.render import settings as S
from gltf_renderer.render.pathtracer import (
    PTMeta,
    PTScene,
    fetch_hit_attributes,
    generate_camera_rays,
)
from gltf_renderer.scene import types as T
from gltf_renderer.utils.math import dot, normalize, reflect, saturate

MAX_BLEND_LAYERS = 4  # depth-sorted transparent layers composited per pixel


def _sample_cube_trilinear(mips, direction, level, quad=None):
    from gltf_renderer.env.environment import sample_cube

    return sample_cube(mips, direction, level, quad=quad)


def _jimenez_conv_kernel():
    """The 13-tap kernel at the exact 2x ratio as ONE 6x6 stride-2 conv
    kernel: every tap lands on a texel pair, so each bilinear tap is a 2x2
    box at a fixed integer shift.

    Tap weights replicate the reference shader's EXACT pattern-2 source —
    including its copy-paste quirk (TransmissionDownsample.cs.hlsl:45-56):
    the (+x,-y) taps appear TWICE at both the 1x and 2x diagonal rings and
    the (-x,-y) taps are missing, so the kernel is asymmetric (double
    weight toward +x,-y; zero toward -x,-y). +y in uv = +v = +row."""
    import numpy as np

    taps = [((0, 0), 0.125)]
    # Inner diagonal ring, shader order: (x,y), (x,-y), (-x,y), (x,-y) dup.
    taps += [((1, 1), 0.125), ((-1, 1), 0.25), ((1, -1), 0.125)]
    taps += [((0, -2), 0.0625), ((0, 2), 0.0625), ((-2, 0), 0.0625), ((2, 0), 0.0625)]
    # Outer diagonal ring, same duplication: (2x,2y), (2x,-2y) x2, (-2x,2y).
    taps += [((2, 2), 0.03125), ((-2, 2), 0.0625), ((2, -2), 0.03125)]
    k = np.zeros((6, 6), np.float32)
    for (sy, sx), w in taps:
        for a in (0, 1):
            for b in (0, 1):
                k[2 + sy + a, 2 + sx + b] += w * 0.25
    return k


def _jimenez_13tap(img, out_h, out_w):
    """CoD: AW 13-tap downsample (TransmissionDownsample.cs.hlsl kernel 2).

    One 6x6 stride-2 conv on the edge-pad-2 planar crop. Odd inputs crop to 2*out first (same sub-texel
    deviation class as the bloom chain, docs/PARITY.md §11)."""
    from gltf_renderer.post.bloom import _conv2

    crop = img[: 2 * out_h, : 2 * out_w]
    pad = jnp.pad(crop, ((2, 2), (2, 2), (0, 0)), mode="edge")
    out = _conv2(jnp.moveaxis(pad, -1, 0), _jimenez_conv_kernel(), (2, 2))
    return jnp.moveaxis(out, 0, -1)


def build_transmission_mips(lit, n_mips: Optional[int] = None, kernel: int = 1):
    """ForwardPass::GenerateTransmissionMips — backdrop blur pyramid.

    kernel: 0 passthrough (the shader's default case: ONE linear sample at
    the output pixel centre == a 2x2 box average at the exact 2x ratio,
    TransmissionDownsample.cs.hlsl:59-62), 1 Bjørge dual-filter 5-tap,
    2 CoD Jimenez 13-tap (with the reference's exact tap quirk — see
    _jimenez_conv_kernel).

    n_mips defaults to the FULL chain (floor(log2(max dim))+1): the
    reference transmission texture is created with mipLevels=0
    (Rasterizer.cpp:63) and Forward.ps.hlsl:254 maps roughness to
    sqrt(a)*(mips-1), so a truncated 6-level pyramid would halve the blur
    a given roughness selects at 1080p (round-4 parity review)."""
    from gltf_renderer.post.bloom import downsample

    if n_mips is None:
        n_mips = int(np.floor(np.log2(max(lit.shape[0], lit.shape[1], 1)))) + 1
    mips = [lit]
    cur = lit
    for _ in range(n_mips - 1):
        h, w = max(cur.shape[0] // 2, 1), max(cur.shape[1] // 2, 1)
        if kernel == 0:
            c2 = cur[: h * 2, : w * 2]
            cur = 0.25 * (c2[0::2, 0::2] + c2[1::2, 0::2]
                          + c2[0::2, 1::2] + c2[1::2, 1::2])
        elif kernel == 2:
            cur = _jimenez_13tap(cur, h, w)
        else:
            cur = downsample(cur, h, w)
        mips.append(cur)
    return mips


def shade_forward(
    scene: PTScene,
    meta: PTMeta,
    hit: bvh_ops.Hit,
    origin,
    direction,
    camera_pos,
    env_intensity,
    screen_uv,
    transmission_mips=None,
    use_env: bool = True,
    use_lights: bool = True,
    mip_scale=None,
):
    """Forward.ps.hlsl main port, vectorized over pixels with valid hits.

    Returns (rgb, alpha) — alpha is base_color.a (Forward.ps.hlsl:296).

    mip_scale: optional (R,) world-space footprint of the pixel at the hit
    (t * angular pixel spread). With a scene mip pyramid (build_atlas_mips)
    textures sample trilinearly at the ray-differential level — the raster
    analogue of Forward.ps.hlsl's derivative-based Sample (the PT keeps
    SampleLevel 0, Material.hlsli:95).
    """
    use_mips = mip_scale is not None and getattr(
        scene.textures, "mip_flat", None) is not None
    attrs = fetch_hit_attributes(scene.world, hit.tri, hit.u, hit.v, direction,
                                 with_footprint=use_mips, raster_flip=True,
                                 ray_origin=origin, ray_t=hit.t)
    mip_base = None
    if use_mips:
        cos_i = jnp.abs(dot(attrs.geometric_normal, direction, keepdims=False))
        fp = mip_scale * attrs.uv_area_ratio / jnp.sqrt(jnp.maximum(cos_i, 1e-2))
        mip_base = jnp.log2(jnp.maximum(fp, 1e-20))
    view = -direction
    sp, extras = get_surface_properties(
        scene.materials,
        scene.textures,
        attrs.material,
        attrs.uv0,
        attrs.uv1,
        attrs.color,
        attrs.normal,
        attrs.tangent,
        attrs.bitangent,
        attrs.geometric_normal,
        view,
        use_geometric_normals=False,
        shading_normal_adaptation=False,  # raster path has no adaptation
        used_slots=meta.used_slots,
        rows_compact=True,  # PTScene rows ARE compact (make_pt_scene);
        # reading them with full-row offsets mis-addressed every slot past
        # the first (fixed round 3 — was silently wrong on multi-slot scenes)
        mip_base=mip_base,
        identity_uv=meta.identity_uv,
        wrap_modes=meta.wrap_modes,
        any_nearest=meta.any_nearest,
    )

    lighting = extras.emissive

    if use_env and meta.has_env:
        ggx_mips = scene.env.ggx
        n_mips = len(ggx_mips)
        rough = jnp.sqrt(sp.roughness_squared[..., 1])
        mip = jnp.clip(rough * (n_mips - 1), 0.0, n_mips - 1)

        # Anisotropic bent normal (Forward.ps.hlsl:214-222).
        a_strength_sq = jnp.clip(
            (sp.roughness_squared[..., 0] - sp.roughness_squared[..., 1])
            / jnp.maximum(1.0 - sp.roughness_squared[..., 1], 1e-6),
            0.0,
            1.0,
        )
        a_strength = jnp.sqrt(a_strength_sq)
        an_tangent = jnp.cross(sp.anisotropy_bitangent, view)
        an_normal = jnp.cross(an_tangent, sp.anisotropy_bitangent)
        bend = 1.0 - a_strength * (1.0 - rough)
        bend = bend * bend
        bend = bend * bend
        bent_normal = normalize(
            an_normal + bend[..., None] * (sp.shading_normal - an_normal)
        )

        ggx_quad = getattr(scene.env, "ggx_quad", None)
        l = reflect(-view, bent_normal)
        ld = env_intensity * _sample_cube_trilinear(ggx_mips, l, mip,
                                                    quad=ggx_quad)

        n_dot_v = saturate(dot(sp.shading_normal, view, keepdims=False))
        a = sp.roughness_squared[..., 1]
        a2 = a * a
        # Pesce/Iwanicki DFG bias-scale (Forward.ps.hlsl:235-237).
        bias = jnp.power(2.0, -(7.0 * n_dot_v + 4.0 * a2))
        scale = 1.0 - bias - a2 * jnp.maximum(
            bias, jnp.minimum(a, 0.739 + 0.323 * n_dot_v) - 0.434
        )
        f0 = (1.0 - sp.ior) / (1.0 + sp.ior)
        f0 = jnp.minimum(f0 * f0 * sp.specular_color, 1.0)
        dfg = (f0 * scale[..., None] + bias[..., None]) * sp.specular_factor
        specular_ibl = dfg * ld

        diffuse_cube = [scene.env.diffuse]
        diffuse_ibl = (
            (1.0 - dfg)
            * sp.albedo
            * env_intensity
            * _sample_cube_trilinear(diffuse_cube, sp.shading_normal,
                                     jnp.zeros_like(a),
                                     quad=getattr(scene.env, "diffuse_quad", None))
        )

        if transmission_mips is not None and meta.has_transmission:
            # Fused trilinear over the flattened backdrop pyramid: one
            # 8-row gather instead of one full-bilinear pass PER MIP.
            t_mips = len(transmission_mips)
            t_a = modulate_roughness(sp.roughness_squared[..., 1:2], sp.ior)[..., 0]
            t_mip = jnp.sqrt(t_a) * (t_mips - 1)
            l0 = jnp.clip(jnp.floor(t_mip).astype(jnp.int32), 0, t_mips - 1)
            l1 = jnp.minimum(l0 + 1, t_mips - 1)
            frac = jnp.clip(t_mip - l0.astype(jnp.float32), 0.0, 1.0)[..., None]
            hs = [m.shape[0] for m in transmission_mips]
            ws = [m.shape[1] for m in transmission_mips]
            offs = list(np.cumsum([0] + [hh * ww for hh, ww in zip(hs, ws)][:-1]))
            flat = jnp.concatenate([m.reshape(-1, 3) for m in transmission_mips])
            hs_j = jnp.asarray(hs, jnp.int32)
            ws_j = jnp.asarray(ws, jnp.int32)
            offs_j = jnp.asarray(offs, jnp.int32)

            def corner_ids(li):
                hh = hs_j[li]
                ww = ws_j[li]
                off = offs_j[li]
                fx = screen_uv[..., 0] * ww.astype(jnp.float32) - 0.5
                fy = screen_uv[..., 1] * hh.astype(jnp.float32) - 0.5
                x0 = jnp.floor(fx).astype(jnp.int32)
                y0 = jnp.floor(fy).astype(jnp.int32)
                tx = (fx - x0)[..., None]
                ty = (fy - y0)[..., None]

                def fi(xi, yi):
                    return off + jnp.clip(yi, 0, hh - 1) * ww + jnp.clip(xi, 0, ww - 1)

                return jnp.stack([fi(x0, y0), fi(x0 + 1, y0), fi(x0, y0 + 1),
                                  fi(x0 + 1, y0 + 1)]), tx, ty

            ids0, tx0, ty0 = corner_ids(l0)
            ids1, tx1, ty1 = corner_ids(l1)
            ids = jnp.concatenate([ids0, ids1])
            c = flat[ids.reshape(-1)].reshape(ids.shape + (3,))

            def lerp(cs, tx, ty):
                return (cs[0] * (1 - tx) + cs[1] * tx) * (1 - ty) + (
                    cs[2] * (1 - tx) + cs[3] * tx) * ty

            backdrop = lerp(c[0:4], tx0, ty0) * (1 - frac) + lerp(c[4:8], tx1, ty1) * frac
            transmission_ibl = sp.albedo * backdrop
            diffuse_ibl = diffuse_ibl + sp.transmissive * (transmission_ibl - diffuse_ibl)

        dielectric_ibl = diffuse_ibl + specular_ibl
        metal_dfg = sp.albedo * scale[..., None] + bias[..., None]
        metal_ibl = metal_dfg * ld
        ibl = dielectric_ibl + sp.metalness * (metal_ibl - dielectric_ibl)

        # Clearcoat IBL (Forward.ps.hlsl:266-275) — statically skipped when
        # no material in the scene has a clearcoat (shader-permutation
        # analogue; saves a full cube gather pass per pixel).
        if meta.has_clearcoat:
            cc_mip = jnp.clip(
                sp.clearcoat_roughness[..., 0] * (n_mips - 1), 0.0, n_mips - 1
            )
            cc_l = reflect(-view, sp.clearcoat_normal)
            cc_ld = env_intensity * _sample_cube_trilinear(
                ggx_mips, cc_l, cc_mip, quad=ggx_quad)
            ibl = fresnel_coat(
                1.5, sp.clearcoat, ibl, cc_ld, dot(sp.clearcoat_normal, view)
            )

        lighting = lighting + ibl * extras.occlusion[..., None]

    if use_lights and meta.num_lights > 0:
        for i in range(meta.num_lights):
            idx = jnp.full(hit.tri.shape, i, jnp.int32)
            ray = get_light_ray(scene.lights, idx, attrs.position)
            f = gltf_bsdf(sp, view, ray.direction, sheen_table=scene.sheen_table)
            lighting = lighting + f * ray.color

    return lighting, extras.base_color[..., 3], extras.alpha_cutoff, extras.alpha_mode


def motion_vectors(
    world, hit, px, py, prev_world_to_clip, prev_position=None, resolution=(0, 0)
):
    """Per-pixel motion vectors (Forward.vs/ps: CalculateMotionVector,
    Forward.ps.hlsl:81-90): previous-frame framebuffer coords minus current
    pixel coords, in pixels. prev_position: optional (VW, 3) previous-frame
    world positions (skinned/animated geometry); defaults to current."""
    w, h = resolution
    tri_c = jnp.clip(hit.tri, 0, None)
    trow = world.tri_rows[tri_c]
    i0, i1, i2 = trow[:, 0], trow[:, 1], trow[:, 2]
    pos_src = world.position if prev_position is None else prev_position
    w0 = (1.0 - hit.u - hit.v)[..., None]
    prev_pos = w0 * pos_src[i0] + hit.u[..., None] * pos_src[i1] + hit.v[..., None] * pos_src[i2]
    p = jnp.concatenate([prev_pos, jnp.ones_like(prev_pos[:, :1])], -1)
    clip = jnp.matmul(p, prev_world_to_clip.T, precision=jax.lax.Precision.HIGHEST)
    ndc = clip[:, :3] / jnp.where(jnp.abs(clip[:, 3:4]) > 1e-8, clip[:, 3:4], 1e-8)
    fb_x = (ndc[:, 0] + 1.0) * 0.5 * w
    fb_y = (-ndc[:, 1] + 1.0) * 0.5 * h
    cur_x = px.astype(jnp.float32) + 0.5
    cur_y = py.astype(jnp.float32) + 0.5
    mv = jnp.stack([fb_x - cur_x, fb_y - cur_y], -1)
    return jnp.where((hit.tri >= 0)[:, None], mv, 0.0)


def _pixel_rays(cpx, cpy, resolution, clip_to_world):
    w, h = resolution
    zero_jitter = jnp.zeros(cpx.shape + (2,), jnp.float32)
    origin, dir_raw = generate_camera_rays(cpx, cpy, (w, h), clip_to_world, zero_jitter)
    ray_len = jnp.sqrt(jnp.maximum(jnp.sum(dir_raw**2, -1), 1e-20))
    direction = dir_raw / ray_len[..., None]
    screen_uv = jnp.stack(
        [(cpx.astype(jnp.float32) + 0.5) / w, (cpy.astype(jnp.float32) + 0.5) / h], -1
    )
    return origin, direction, ray_len, screen_uv


def _alpha_retry_raster(scene, meta, hit, origin, direction, t_max):
    """Re-trace past alpha-REJECTED masked texels (the raster 'discard')."""
    from gltf_renderer.render.pathtracer import _needs_alpha_retry, closest_hit

    # int32 lane-mask carry, as in pathtracer._alpha_retry.
    def cond(state):
        retry_i, _h, it = state
        return jnp.any(retry_i > 0) & (it < 8)

    def body(state):
        retry_i, cur, it = state
        retry = retry_i > 0
        tmin2 = jnp.where(retry, cur.t * (1.0 + 1e-5) + 1e-6, t_max + 1.0)
        nh = closest_hit(
            scene, meta, origin, direction, tmin2, t_max,
            blend_mode=bvh_ops.BLEND_EXCLUDE,
        )
        merged = bvh_ops.Hit(
            t=jnp.where(retry, nh.t, cur.t),
            tri=jnp.where(retry, nh.tri, cur.tri),
            u=jnp.where(retry, nh.u, cur.u),
            v=jnp.where(retry, nh.v, cur.v),
        )
        retry = _needs_alpha_retry(scene, meta, merged) & retry
        return retry.astype(jnp.int32), merged, it + 1

    retry0 = _needs_alpha_retry(scene, meta, hit).astype(jnp.int32)
    _, hit, _ = jax.lax.while_loop(cond, body, (retry0, hit, 0))
    return hit


def _map_chunks(fn, arrays, n, chunk):
    """lax.map `fn` over CHUNK-sized slices of flat (N, ...) arrays.

    Bounds peak gather/working-set size exactly like the PT's chunking
    (pathtracer.trace): one compiled chunk body, sequential execution.
    Returns outputs concatenated back to N rows.
    """
    chunk = min(chunk, n)  # small frames: one unpadded chunk
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n

    def prep(x):
        if pad:
            x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
        return x.reshape((n_chunks, chunk) + x.shape[1:])

    outs = jax.lax.map(fn, tuple(prep(a) for a in arrays))
    return tuple(o.reshape((n_chunks * chunk,) + o.shape[2:])[:n] for o in outs)


def render(
    scene: PTScene,
    meta: PTMeta,
    render_settings: S.RenderSettings,
    params: S.PathTracerParams,
    clip_to_world,
    camera_pos,
    resolution,
    frame,
    prev_world_to_clip=None,
    prev_position=None,
    with_motion: bool = False,
    pixel_offset=(0, 0),  # for sharded tiles: global pixel coords of (0, 0)
    full_resolution=None,  # full image size when rendering a tile
    lit_gather=None,  # sharded: assemble the FULL lit image for the
    # transmission backdrop (e.g. an all_gather over the tile axis); the
    # blend pass samples the backdrop at absolute screen uv, so per-shard
    # local mips would diverge from the single-device render at tile seams
):
    """Rasterizer::DrawScene equivalent -> (h, w, 3) HDR linear image
    (+ (h, w, 2) motion vectors when with_motion).

    Visibility is BVH primary rays (z-buffer-identical for opaque
    geometry); alpha-REJECTED masked texels are re-traced past by the retry
    loop below, and blended layers use ray queries.

    Pixels stream through RAY_CHUNK-sized TILE-ORDERED chunks reusing the
    path tracer's fused gather/shading paths.
    """
    from gltf_renderer.render.pathtracer import (
        RAY_CHUNK, _from_tile_order, _tile_order, closest_hit,
    )

    w, h = resolution
    if full_resolution is None:
        full_resolution = resolution
    fw, fh = full_resolution
    px_t, py_t, _valid_t = _tile_order(w, h)
    px = jnp.asarray(px_t) + pixel_offset[0]
    py = jnp.asarray(py_t) + pixel_offset[1]
    n = px.shape[0]

    env_intensity = params.environment_intensity
    use_env = meta.has_env

    # Per-pixel angular spread (camera rays are affine in pixel coords):
    # |raw(px+1)-raw(px)| in far-plane units; at a hit the world footprint is
    # t * s0 / |raw| (used for texture mip selection when the scene carries
    # a mip pyramid).
    has_mips = getattr(scene.textures, "mip_flat", None) is not None
    if has_mips:
        _o3, raw3 = generate_camera_rays(
            jnp.asarray([0, 1, 0], jnp.int32), jnp.asarray([0, 0, 1], jnp.int32),
            (fw, fh), clip_to_world, jnp.zeros((3, 2), jnp.float32),
        )
        s0 = jnp.sqrt(
            jnp.linalg.norm(raw3[1] - raw3[0]) * jnp.linalg.norm(raw3[2] - raw3[0])
        )

    # --- Opaque + alpha-test + background pass, chunked.
    def opaque_chunk(args):
        cpx, cpy = args
        origin, direction, t_max, screen_uv = _pixel_rays(
            cpx, cpy, (fw, fh), clip_to_world
        )
        hit = closest_hit(
            scene, meta, origin, direction, jnp.zeros_like(t_max), t_max,
            blend_mode=bvh_ops.BLEND_EXCLUDE,
        )
        if meta.has_masked:
            hit = _alpha_retry_raster(scene, meta, hit, origin, direction, t_max)

        valid = hit.tri >= 0
        mip_scale = (
            jnp.maximum(hit.t, 0.0) * s0 / jnp.maximum(t_max, 1e-20)
            if has_mips else None
        )
        rgb, _alpha, _cut, _mode = shade_forward(
            scene, meta, hit, origin, direction, camera_pos, env_intensity,
            screen_uv, transmission_mips=None, use_env=use_env, use_lights=True,
            mip_scale=mip_scale,
        )
        # Background (Background.ps.hlsl: env cube at ray direction).
        if use_env:
            from gltf_renderer.env.environment import env_radiance

            bg = env_intensity * env_radiance(scene.env, normalize(direction))
        else:
            # No environment: the reference rasterizer clears to black and
            # draws no background (Rasterizer.cpp:183, :222-229) — unlike
            # the PT, whose miss shader returns environment_color.
            bg = jnp.zeros_like(rgb)
        lit = jnp.where(valid[..., None], rgb, bg)
        return lit, jnp.where(valid, hit.t, jnp.inf), hit.tri, hit.u, hit.v

    lit_f, opaque_t, tri_f, u_f, v_f = _map_chunks(opaque_chunk, (px, py), n, RAY_CHUNK)
    lit = _from_tile_order(lit_f, w, h)

    # --- Transmission backdrop mips + blended/transmissive layers, chunked.
    if meta.has_blend:
        backdrop = lit if lit_gather is None else lit_gather(lit)
        trans_mips = build_transmission_mips(backdrop)

        def blend_chunk(args):
            cpx, cpy, c_opaque_t, c_lit = args
            origin, direction, t_max, screen_uv = _pixel_rays(
                cpx, cpy, (fw, fh), clip_to_world
            )
            # Collect up to MAX_BLEND_LAYERS blend hits front-to-back, then
            # composite back-to-front (Rasterizer sorts draws; we sort
            # exactly per pixel along the ray).
            layer_rgb = []
            layer_a = []
            cur_tmin = jnp.zeros_like(t_max)
            for _ in range(MAX_BLEND_LAYERS):
                bh = closest_hit(
                    scene, meta, origin, direction, cur_tmin,
                    jnp.minimum(c_opaque_t, t_max), blend_mode=bvh_ops.BLEND_ONLY,
                )
                ok = bh.tri >= 0
                b_mip = (
                    jnp.maximum(bh.t, 0.0) * s0 / jnp.maximum(t_max, 1e-20)
                    if has_mips else None
                )
                srgb, sa, scut, smode = shade_forward(
                    scene, meta, bh, origin, direction, camera_pos, env_intensity,
                    screen_uv, transmission_mips=trans_mips, use_env=use_env,
                    use_lights=True, mip_scale=b_mip,
                )
                # BLEND uses base alpha; transmissive OPAQUE surfaces
                # composite with alpha 1 (color already has the backdrop).
                a_eff = jnp.where(smode == T.ALPHA_MODE_BLEND, sa, 1.0)
                layer_rgb.append(srgb)
                layer_a.append(jnp.where(ok, a_eff, 0.0))
                cur_tmin = jnp.where(ok, bh.t * (1.0 + 1e-5) + 1e-6, t_max + 1.0)
            out = c_lit
            for i in range(MAX_BLEND_LAYERS - 1, -1, -1):
                a = layer_a[i][..., None]
                out = out + a * (layer_rgb[i] - out)
            return (out,)

        (lit_f2,) = _map_chunks(
            blend_chunk, (px, py, opaque_t, lit_f), n, RAY_CHUNK
        )
        lit = _from_tile_order(lit_f2, w, h)

    if with_motion:
        prev_c2w = prev_world_to_clip
        if prev_c2w is None:
            prev_c2w = jnp.linalg.inv(clip_to_world)
        hit_full = bvh_ops.Hit(t=opaque_t, tri=tri_f, u=u_f, v=v_f)
        mv = _from_tile_order(motion_vectors(
            scene.world, hit_full, px, py, prev_c2w, prev_position, (fw, fh)
        ), w, h)
        return lit, mv
    return lit
