import numpy as np

from gltf_renderer.scene.gltf import load_gltf
from gltf_renderer.scene import flatten
from gltf_renderer.scene import types as T
from tests.scenes import write_box_gltf, write_textured_sphere_glb, write_skinned_gltf, write_morph_gltf


def test_load_box(tmp_path):
    path = write_box_gltf(str(tmp_path / "box.gltf"))
    scene = load_gltf(path)
    assert scene.pools.positions.shape == (24, 3)
    assert scene.pools.tri_vertex.shape == (12, 3)
    assert len(scene.nodes) == 2
    assert len(scene.light_nodes) == 1
    # Material 0 is the default; the box uses material 1.
    assert scene.primitives.material[0] == 1
    np.testing.assert_allclose(
        scene.materials.base_color_factor[1], [0.8, 0.2, 0.2, 1.0], atol=1e-6
    )
    # Normals survive quantization roughly.
    n = scene.pools.normals
    assert np.abs(np.linalg.norm(n, axis=-1) - 1).max() < 1e-3


def test_box_flatten_world():
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        path = write_box_gltf(os.path.join(d, "box.gltf"))
        scene = load_gltf(path)
        tf = flatten.compute_global_transforms(scene)
        # Y-up -> Z-up: the +Y face normal (0,1,0) becomes +Z.
        plan = flatten.build_instance_plan(scene)
        tri_flags = flatten.plan_tri_flags(plan, scene.primitives)
        import jax.numpy as jnp

        world = flatten.build_world_geometry(
            jax_pools(scene), plan, jnp.asarray(tf), jnp.asarray(flatten.normal_transforms(tf)),
            tri_flags,
        )
        wp = np.asarray(world.position)
        assert wp.shape == (24, 3)
        # glTF (0, 0.5, 0) (top in Y-up) -> world (0, 0, 0.5).
        src_top = np.asarray(scene.pools.positions)
        k = np.argmax(src_top[:, 1])
        assert abs(wp[k][2] - 0.5) < 1e-5
        # Lights gathered in world space.
        lights = flatten.gather_lights(scene, tf)
        np.testing.assert_allclose(lights.position[0], [2.0, -2.0, 2.0], atol=1e-5)


def jax_pools(scene):
    import jax.numpy as jnp
    import jax

    return jax.tree.map(jnp.asarray, scene.pools)


def test_load_glb_textured(tmp_path):
    path = write_textured_sphere_glb(str(tmp_path / "sphere.glb"))
    scene = load_gltf(path)
    assert scene.textures.atlas.shape[2] == 4
    assert scene.textures.width[0] == 64
    assert scene.materials.tex_index[1, T.TEX_ALBEDO] == 0
    assert scene.textures.srgb[0] == 1
    assert scene.textures.wrap_t[0] == T.WRAP_CLAMP


def test_load_skinned(tmp_path):
    path = write_skinned_gltf(str(tmp_path / "skin.gltf"))
    scene = load_gltf(path)
    assert len(scene.skins) == 1
    assert list(scene.skins[0].joints) == [1, 2]
    assert len(scene.animations) == 1
    assert scene.animations[0].duration == 2.0
    assert scene.primitives.has_joints[0] == 1


def test_load_morph(tmp_path):
    path = write_morph_gltf(str(tmp_path / "morph.gltf"))
    scene = load_gltf(path)
    assert scene.primitives.morph_count[0] == 1
    assert scene.pools.morph_pos.shape == (24, 3)
    assert scene.meshes[0].weights is not None


def test_sparse_accessor(tmp_path):
    """Sparse POSITION accessor overrides base values (TinyGltfTools parity)."""
    import base64, json
    import numpy as np

    base = np.zeros((6, 3), np.float32)
    blob = base.tobytes()                                  # 72 bytes
    idx = np.asarray([1, 3], np.uint16).tobytes()          # 4 bytes
    vals = np.asarray([[1, 2, 3], [4, 5, 6]], np.float32).tobytes()  # 24 bytes
    blob2 = blob + idx + vals
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "buffers": [{"byteLength": len(blob2),
                     "uri": "data:application/octet-stream;base64," + base64.b64encode(blob2).decode()}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 72},
            {"buffer": 0, "byteOffset": 72, "byteLength": 4},
            {"buffer": 0, "byteOffset": 76, "byteLength": 24},
        ],
        "accessors": [{
            "bufferView": 0, "componentType": 5126, "count": 6, "type": "VEC3",
            "sparse": {"count": 2,
                       "indices": {"bufferView": 1, "componentType": 5123},
                       "values": {"bufferView": 2}},
        }],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
        "nodes": [{"mesh": 0}], "scenes": [{"nodes": [0]}],
    }
    path = str(tmp_path / "sparse.gltf")
    json.dump(doc, open(path, "w"))
    scene = load_gltf(path)
    pos = np.asarray(scene.pools.positions)
    np.testing.assert_allclose(pos[1], [1, 2, 3])
    np.testing.assert_allclose(pos[3], [4, 5, 6])
    np.testing.assert_allclose(pos[0], [0, 0, 0])


def test_texture_transform_roundtrip(tmp_path):
    """KHR_texture_transform parameters land in the material table + rows."""
    import json

    path = write_box_gltf(str(tmp_path / "b.gltf"))
    doc = json.load(open(path))
    # Attach a dummy texture with a transform.
    import base64
    import numpy as np_
    from gltf_renderer.utils.png import encode_png
    png = base64.b64encode(encode_png(np_.full((4, 4, 4), 128, np_.uint8))).decode()
    doc["images"] = [{"uri": "data:image/png;base64," + png}]
    doc["textures"] = [{"source": 0}]
    doc.setdefault("extensionsUsed", []).append("KHR_texture_transform")
    doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {
        "index": 0,
        "extensions": {"KHR_texture_transform": {
            "offset": [0.25, 0.5], "scale": [2.0, 3.0], "rotation": 0.7}},
    }
    json.dump(doc, open(path, "w"))
    scene = load_gltf(path)
    m = scene.materials
    np.testing.assert_allclose(m.tex_offset[1, T.TEX_ALBEDO], [0.25, 0.5])
    np.testing.assert_allclose(m.tex_scale[1, T.TEX_ALBEDO], [2.0, 3.0])
    np.testing.assert_allclose(m.tex_rotation[1, T.TEX_ALBEDO], 0.7, atol=1e-6)
    # Packed row carries the same values.
    b = T.MATERIAL_ROW_FACTORS + T.MATERIAL_SLOT_STRIDE * T.TEX_ALBEDO
    np.testing.assert_allclose(m.rows[1, b + 2], 0.7, atol=1e-6)
    np.testing.assert_allclose(m.rows[1, b + 3:b + 5], [0.25, 0.5])


def test_dispersion_roundtrip(tmp_path):
    """KHR_materials_dispersion value lands in the material table (stored,
    unused by shading — reference parity, Gltf.cpp:543-547)."""
    import json

    path = write_box_gltf(str(tmp_path / "d.gltf"))
    doc = json.load(open(path))
    doc.setdefault("extensionsUsed", []).append("KHR_materials_dispersion")
    doc["materials"][0].setdefault("extensions", {})["KHR_materials_dispersion"] = {
        "dispersion": 0.13
    }
    json.dump(doc, open(path, "w"))
    scene = load_gltf(path)
    np.testing.assert_allclose(scene.materials.dispersion[1], 0.13, atol=1e-6)
    np.testing.assert_allclose(scene.materials.dispersion[0], 0.0)  # default mat
