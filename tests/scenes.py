"""Shim: procedural test scenes live in the package (used by bench + graft)."""

from gltf_renderer.scene.procedural import (  # noqa: F401
    box_mesh,
    uv_sphere,
    write_box_gltf,
    write_textured_sphere_glb,
    write_skinned_gltf,
    write_morph_gltf,
    write_camera_anim_gltf,
)
from gltf_renderer.scene.procedural import write_materials_gltf, write_foliage_gltf  # noqa: F401,E501
