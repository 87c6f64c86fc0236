"""Loader coverage on official-asset LAYOUTS (BASELINE configs name real
glTF-Sample-Assets; the offline environment cannot fetch them, so these are
structural reconstructions — interleaved strided accessors, matrix nodes,
two-target morphs, multi-UV — per docs/PARITY.md "BASELINE assets")."""

import numpy as np
import pytest

from gltf_renderer.scene.gltf import load_gltf
from gltf_renderer.scene.procedural import (
    box_mesh,
    write_box_official_layout_gltf,
    write_morph_cube_official_layout_gltf,
    write_multiuv_gltf,
)


def test_box_official_layout_interleaved(tmp_path):
    """Interleaved NORMAL/POSITION bufferView (byteStride 24) + matrix node
    (the official Box.gltf structure) decode exactly."""
    path = write_box_official_layout_gltf(str(tmp_path / "box_official.gltf"))
    scene = load_gltf(path)
    p_ref, n_ref, _uv, idx_ref = box_mesh()
    pos = np.asarray(scene.pools.positions)
    nrm = np.asarray(scene.pools.normals)
    np.testing.assert_allclose(pos[: len(p_ref)], p_ref, atol=1e-6)
    # Loader may quantize normals (tangent-space parity); direction survives.
    dots = np.sum(nrm[: len(n_ref)] * n_ref, axis=-1)
    assert (dots > 0.99).all()
    # Material constants ("Red").
    base = np.asarray(scene.materials.base_color_factor)
    assert np.allclose(base[-1], [0.8, 0.0, 0.0, 1.0], atol=1e-6) or np.allclose(
        base[1], [0.8, 0.0, 0.0, 1.0], atol=1e-6
    )
    # Root matrix node: applied in the global transforms.
    from gltf_renderer.scene import flatten

    tf = flatten.compute_global_transforms(scene)
    mesh_node = next(i for i, nd in enumerate(scene.nodes) if nd.mesh >= 0)
    m = np.asarray(tf[mesh_node])
    assert not np.allclose(m[:3, :3], np.eye(3) * m[0, 0]), (
        "matrix rotation should appear in the mesh node's global transform"
    )


def test_box_official_layout_renders(tmp_path):
    from gltf_renderer.camera import look_at
    from gltf_renderer.render import settings as S
    from gltf_renderer.render.renderer import Renderer

    path = write_box_official_layout_gltf(str(tmp_path / "box_official.gltf"))
    r = Renderer(S.RenderSettings(width=48, height=32,
                                  pt=S.PathTracerSettings(max_bounces=0, min_bounces=0)))
    r.load_scene(path)
    from tests.test_env import _test_equirect

    r.load_environment(_test_equirect())
    r.camera.aspect_ratio = 1.5
    r.camera.z_near = 0.01
    r.camera.world_to_view = look_at([2.0, -2.0, 1.5], [0, 0, 0])
    img = r.draw_frame()
    assert img.std() > 1.0  # box visible against the env


def test_morph_cube_official_layout(tmp_path):
    """Two named morph targets + weights animation (AnimatedMorphCube
    structure): both weights drive deformation per tick."""
    from gltf_renderer.anim.animation import animate

    path = write_morph_cube_official_layout_gltf(str(tmp_path / "amc.gltf"))
    scene = load_gltf(path)
    prim0 = 0
    assert int(scene.primitives.morph_count[prim0]) == 2
    anim = scene.animations[0]
    pose_a = animate(scene, anim, 0.0)
    pose_b = animate(scene, anim, 1.0)
    w_a = pose_a.weights[0]  # node 0 -> (2,) morph weights
    w_b = pose_b.weights[0]
    assert not np.allclose(w_a, w_b)
    # At t=0: weights ~ (0, 1); at t=1: ~ (0.7, 0.7).
    assert w_a[0] == pytest.approx(0.0, abs=1e-5)
    assert w_a[1] == pytest.approx(1.0, abs=1e-5)
    assert w_b[0] == pytest.approx(np.sin(np.pi / 4), abs=1e-5)


def test_multiuv_color0(tmp_path):
    """TEXCOORD_1-driven occlusion + u16-normalized COLOR_0 decode."""
    scene = load_gltf(write_multiuv_gltf(str(tmp_path / "multiuv.gltf")))
    col = np.asarray(scene.pools.color)
    assert col[:, 0].max() == pytest.approx(1.0, abs=1e-4)
    assert col[:, 1].min() == pytest.approx(0.0, abs=1e-4)
    assert col[:, 1].max() == pytest.approx(1.0, abs=1e-4)
    uv0 = np.asarray(scene.pools.uv0)
    uv1 = np.asarray(scene.pools.uv1)
    assert not np.allclose(uv0[: 24], uv1[: 24])
    # Occlusion texture is bound to UV set 1.
    from gltf_renderer.scene import types as T

    assert int(np.asarray(scene.materials.tex_uvset)[-1, T.TEX_OCCLUSION]) == 1
