"""Procedural glTF scenes (no network: sample assets are generated).

Builds real .gltf/.glb files on disk so tests exercise the full loader path,
mirroring the glTF-Sample-Assets configs in BASELINE.json (Box, textured,
skinned, morphed).
"""

from __future__ import annotations

import base64
import json
import os

import numpy as np

from gltf_renderer.utils.png import encode_png


def _buf_uri(data: bytes) -> str:
    return "data:application/octet-stream;base64," + base64.b64encode(data).decode()


def _acc(doc, bin_parts, arr, target=None, acc_type=None, normalized=False):
    """Append arr to the binary blob and register bufferView + accessor."""
    arr = np.ascontiguousarray(arr)
    comp_map = {
        np.dtype(np.float32): 5126,
        np.dtype(np.uint32): 5125,
        np.dtype(np.uint16): 5123,
        np.dtype(np.uint8): 5121,
        np.dtype(np.int16): 5122,
        np.dtype(np.int8): 5120,
    }
    offset = sum(len(p) for p in bin_parts)
    pad = (-offset) % 4
    if pad:
        bin_parts.append(b"\x00" * pad)
        offset += pad
    data = arr.tobytes()
    bin_parts.append(data)
    doc.setdefault("bufferViews", []).append(
        {"buffer": 0, "byteOffset": offset, "byteLength": len(data), **({"target": target} if target else {})}
    )
    if acc_type is None:
        acc_type = {1: "SCALAR", 2: "VEC2", 3: "VEC3", 4: "VEC4", 16: "MAT4"}[
            1 if arr.ndim == 1 else arr.shape[-1] if arr.ndim == 2 else 16
        ]
    count = len(arr)
    acc = {
        "bufferView": len(doc["bufferViews"]) - 1,
        "componentType": comp_map[arr.dtype],
        "count": count,
        "type": acc_type,
    }
    if normalized:
        acc["normalized"] = True
    if acc_type == "VEC3" and arr.dtype == np.float32:
        acc["min"] = arr.reshape(count, -1).min(0).tolist()
        acc["max"] = arr.reshape(count, -1).max(0).tolist()
    doc.setdefault("accessors", []).append(acc)
    return len(doc["accessors"]) - 1


def box_mesh():
    """Unit cube centered at origin with per-face normals/uv."""
    p, n, uv, idx = [], [], [], []
    faces = [
        (np.array([0, 0, 1]), np.array([1, 0, 0]), np.array([0, 1, 0])),
        (np.array([0, 0, -1]), np.array([-1, 0, 0]), np.array([0, 1, 0])),
        (np.array([1, 0, 0]), np.array([0, 0, -1]), np.array([0, 1, 0])),
        (np.array([-1, 0, 0]), np.array([0, 0, 1]), np.array([0, 1, 0])),
        (np.array([0, 1, 0]), np.array([1, 0, 0]), np.array([0, 0, -1])),
        (np.array([0, -1, 0]), np.array([1, 0, 0]), np.array([0, 0, 1])),
    ]
    for fn, fu, fv in faces:
        base = len(p)
        for su, sv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            p.append(0.5 * (fn + su * fu + sv * fv))
            n.append(fn)
            uv.append([(su + 1) / 2, (sv + 1) / 2])
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return (
        np.asarray(p, np.float32),
        np.asarray(n, np.float32),
        np.asarray(uv, np.float32),
        np.asarray(idx, np.uint16),
    )


def uv_sphere(n_lat=32, n_lon=64, radius=0.5):
    lat = np.linspace(0, np.pi, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    verts, norms, uvs = [], [], []
    for i, th in enumerate(lat):
        for j, ph in enumerate(lon):
            d = np.array([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)])
            verts.append(radius * d)
            norms.append(d)
            uvs.append([j / n_lon, i / (n_lat - 1)])
    idx = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            # CCW seen from outside (glTF front faces): outward normals.
            idx += [a, b, c, b, d, c]
    return (
        np.asarray(verts, np.float32),
        np.asarray(norms, np.float32),
        np.asarray(uvs, np.float32),
        np.asarray(idx, np.uint32),
    )


def write_box_gltf(path, base_color=(0.8, 0.2, 0.2, 1.0), metallic=0.0, roughness=0.6,
                   with_light=True, double_box=False):
    """Box + KHR punctual point light + perspective camera (BASELINE config 1)."""
    doc = {"asset": {"version": "2.0"}, "scene": 0}
    bin_parts = []
    p, n, uv, idx = box_mesh()
    ip = _acc(doc, bin_parts, p, target=34962)
    inn = _acc(doc, bin_parts, n, target=34962)
    iuv = _acc(doc, bin_parts, uv, target=34962)
    ii = _acc(doc, bin_parts, idx, target=34963)
    doc["meshes"] = [
        {
            "primitives": [
                {
                    "attributes": {"POSITION": ip, "NORMAL": inn, "TEXCOORD_0": iuv},
                    "indices": ii,
                    "material": 0,
                }
            ]
        }
    ]
    doc["materials"] = [
        {
            "pbrMetallicRoughness": {
                "baseColorFactor": list(base_color),
                "metallicFactor": metallic,
                "roughnessFactor": roughness,
            }
        }
    ]
    nodes = [{"mesh": 0, "name": "box"}]
    scene_nodes = [0]
    if double_box:
        nodes.append({"mesh": 0, "translation": [1.5, 0.0, 0.0], "name": "box2"})
        scene_nodes.append(1)
    if with_light:
        doc["extensionsUsed"] = ["KHR_lights_punctual"]
        doc["extensions"] = {
            "KHR_lights_punctual": {
                "lights": [{"type": "point", "intensity": 40.0, "color": [1, 1, 1]}]
            }
        }
        nodes.append(
            {
                "translation": [2.0, 2.0, 2.0],
                "extensions": {"KHR_lights_punctual": {"light": 0}},
                "name": "light",
            }
        )
        scene_nodes.append(len(nodes) - 1)
    doc["nodes"] = nodes
    doc["scenes"] = [{"nodes": scene_nodes}]
    blob = b"".join(bin_parts)
    doc["buffers"] = [{"byteLength": len(blob), "uri": _buf_uri(blob)}]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def write_textured_sphere_glb(path, tex_size=64, n_lat=16, n_lon=32,
                              metallic=0.0, roughness=0.8):
    """GLB container + embedded PNG texture + MR material (loader GLB path)."""
    import struct

    doc = {"asset": {"version": "2.0"}, "scene": 0}
    bin_parts = []
    p, n, uv, idx = uv_sphere(n_lat, n_lon)
    ip = _acc(doc, bin_parts, p, target=34962)
    inn = _acc(doc, bin_parts, n, target=34962)
    iuv = _acc(doc, bin_parts, uv, target=34962)
    ii = _acc(doc, bin_parts, idx, target=34963)

    # Checkerboard PNG.
    yy, xx = np.meshgrid(np.arange(tex_size), np.arange(tex_size), indexing="ij")
    checker = (((xx // 8) + (yy // 8)) % 2).astype(np.uint8)
    img = np.stack([checker * 255, 64 + checker * 128, 255 - checker * 200, np.full_like(checker, 255)], -1)
    png = encode_png(img)
    offset = sum(len(b) for b in bin_parts)
    pad = (-offset) % 4
    if pad:
        bin_parts.append(b"\x00" * pad)
        offset += pad
    bin_parts.append(png)
    doc["bufferViews"].append({"buffer": 0, "byteOffset": offset, "byteLength": len(png)})
    doc["images"] = [{"bufferView": len(doc["bufferViews"]) - 1, "mimeType": "image/png"}]
    doc["samplers"] = [{"wrapS": 10497, "wrapT": 33071}]
    doc["textures"] = [{"source": 0, "sampler": 0}]
    doc["materials"] = [
        {
            "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "metallicFactor": metallic,
                "roughnessFactor": roughness,
            }
        }
    ]
    doc["meshes"] = [
        {
            "primitives": [
                {
                    "attributes": {"POSITION": ip, "NORMAL": inn, "TEXCOORD_0": iuv},
                    "indices": ii,
                    "material": 0,
                }
            ]
        }
    ]
    doc["nodes"] = [{"mesh": 0}]
    doc["scenes"] = [{"nodes": [0]}]
    blob = b"".join(bin_parts)
    pad = (-len(blob)) % 4
    blob += b"\x00" * pad
    doc["buffers"] = [{"byteLength": len(blob)}]

    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    glb = struct.pack("<III", 0x46546C67, 2, total)
    glb += struct.pack("<II", len(js), 0x4E4F534A) + js
    glb += struct.pack("<II", len(blob), 0x004E4942) + blob
    with open(path, "wb") as f:
        f.write(glb)
    return path


def write_skinned_gltf(path, strips: int = 1):
    """Two-bone skinned quad strip + rotation animation (BrainStem-style).

    strips > 1 instantiates that many independently-skinned strips (one SKIN
    each, x-offset) — exercises multi-skin scenes (dryrun_multichip)."""
    doc = {"asset": {"version": "2.0"}, "scene": 0}
    bin_parts = []
    # Vertical strip of quads along +Y in glTF space, skinned to 2 joints.
    seg = 4
    pos, nrm, joints, weights, idx = [], [], [], [], []
    for i in range(seg + 1):
        y = i / seg * 2.0
        w1 = max(0.0, (y - 1.0)) if y > 1.0 else 0.0
        w1 = min(y / 2.0, 1.0)
        for x in (-0.1, 0.1):
            pos.append([x, y, 0.0])
            nrm.append([0.0, 0.0, 1.0])
            joints.append([0, 1, 0, 0])
            weights.append([1.0 - w1, w1, 0.0, 0.0])
    for i in range(seg):
        a = i * 2
        idx += [a, a + 1, a + 2, a + 1, a + 3, a + 2]
    ip = _acc(doc, bin_parts, np.asarray(pos, np.float32), target=34962)
    inn = _acc(doc, bin_parts, np.asarray(nrm, np.float32), target=34962)
    ij = _acc(doc, bin_parts, np.asarray(joints, np.uint16), target=34962)
    iw = _acc(doc, bin_parts, np.asarray(weights, np.float32), target=34962)
    ii = _acc(doc, bin_parts, np.asarray(idx, np.uint16), target=34963)

    ibm = np.stack([np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)])
    ibm[1][3][1] = -1.0  # column-major: translation row is the 4th column
    i_ibm = _acc(doc, bin_parts, ibm.reshape(2, 16), acc_type="MAT4")

    times = np.asarray([0.0, 1.0, 2.0], np.float32)
    angle = np.pi / 4
    rots = np.asarray(
        [
            [0, 0, 0, 1],
            [0, 0, np.sin(angle / 2), np.cos(angle / 2)],
            [0, 0, 0, 1],
        ],
        np.float32,
    )
    it = _acc(doc, bin_parts, times)
    ir = _acc(doc, bin_parts, rots)

    mesh_def = {
        "primitives": [{"attributes": {"POSITION": ip, "NORMAL": inn, "JOINTS_0": ij, "WEIGHTS_0": iw}, "indices": ii}]
    }
    # One mesh PER strip (accessors shared): each strip's primitive gets its
    # own pool range, so per-skin deformation stays independent.
    doc["meshes"] = [dict(mesh_def) for _ in range(strips)]
    doc["skins"] = []
    doc["nodes"] = []
    channels = []
    scene_nodes = []
    for s in range(strips):
        base = len(doc["nodes"])
        xoff = 0.6 * s
        doc["skins"].append(
            {"joints": [base + 1, base + 2], "inverseBindMatrices": i_ibm}
        )
        doc["nodes"] += [
            {"mesh": s, "skin": s, "translation": [xoff, 0.0, 0.0],
             "name": f"strip{s}"},
            {"children": [base + 2], "translation": [xoff, 0.0, 0.0],
             "name": f"root_joint{s}"},
            {"translation": [0, 1, 0], "name": f"tip_joint{s}"},
        ]
        channels.append(
            {"sampler": 0, "target": {"node": base + 2, "path": "rotation"}}
        )
        scene_nodes += [base, base + 1]
    doc["animations"] = [
        {
            "samplers": [{"input": it, "output": ir, "interpolation": "LINEAR"}],
            "channels": channels,
        }
    ]
    doc["scenes"] = [{"nodes": scene_nodes}]
    blob = b"".join(bin_parts)
    doc["buffers"] = [{"byteLength": len(blob), "uri": _buf_uri(blob)}]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def write_box_official_layout_gltf(path):
    """Structural reconstruction of glTF-Sample-Assets Box.gltf.

    The official sample assets are not fetchable in this offline
    environment (zero egress), so this reproduces the official file's exact
    STRUCTURE for loader coverage the tightly-packed generators miss:
    one INTERLEAVED bufferView (NORMAL at byteOffset 0, POSITION at 12,
    byteStride 24 — Box.gltf's layout), a root node carrying a `matrix`
    (the official Box root holds a rotation matrix), a child mesh node,
    and the official material constants ("Red": baseColorFactor
    [0.8, 0, 0, 1], metallic 0). Exercises TinyGltfTools.h:284-299-style
    strided iteration and Gltf.cpp:658-668 matrix nodes.
    """
    doc = {"asset": {"version": "2.0"}, "scene": 0}
    p, n, _uv, idx = box_mesh()
    # Interleave [normal, position] per vertex, stride 24.
    inter = np.empty((len(p), 6), np.float32)
    inter[:, 0:3] = n
    inter[:, 3:6] = p
    blob_i = inter.tobytes()
    idx16 = np.asarray(idx, np.uint16)
    pad = (-len(blob_i)) % 4
    blob = blob_i + b"\x00" * pad + idx16.tobytes()
    doc["bufferViews"] = [
        {"buffer": 0, "byteOffset": 0, "byteLength": len(blob_i),
         "byteStride": 24, "target": 34962},
        {"buffer": 0, "byteOffset": len(blob_i) + pad,
         "byteLength": idx16.nbytes, "target": 34963},
    ]
    doc["accessors"] = [
        {"bufferView": 0, "byteOffset": 0, "componentType": 5126,
         "count": len(p), "type": "VEC3"},
        {"bufferView": 0, "byteOffset": 12, "componentType": 5126,
         "count": len(p), "type": "VEC3",
         "min": p.min(0).tolist(), "max": p.max(0).tolist()},
        {"bufferView": 1, "byteOffset": 0, "componentType": 5123,
         "count": len(idx16), "type": "SCALAR"},
    ]
    doc["materials"] = [
        {"name": "Red",
         "pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.0, 0.0, 1.0],
                                  "metallicFactor": 0.0}}
    ]
    doc["meshes"] = [
        {"name": "Mesh",
         "primitives": [{"attributes": {"NORMAL": 0, "POSITION": 1},
                         "indices": 2, "material": 0, "mode": 4}]}
    ]
    # Official Box: root node carries a basis-flip matrix, child holds the mesh.
    doc["nodes"] = [
        {"children": [1],
         "matrix": [1, 0, 0, 0, 0, 0, -1, 0, 0, 1, 0, 0, 0, 0, 0, 1]},
        {"mesh": 0},
    ]
    doc["scenes"] = [{"nodes": [0]}]
    doc["buffers"] = [{"byteLength": len(blob), "uri": _buf_uri(blob)}]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def write_morph_cube_official_layout_gltf(path):
    """Structural reconstruction of glTF-Sample-Assets AnimatedMorphCube.

    Official layout facts reproduced: TWO morph targets ("Angle"/"Thin"
    POSITION deltas), per-target NORMAL deltas, a weights animation driving
    both channels, and a mesh node with a rotation quaternion. (Binary
    payload is synthetic — official assets unavailable offline; see
    docs/PARITY.md.)"""
    doc = {"asset": {"version": "2.0"}, "scene": 0}
    bin_parts = []
    p, n, _uv, idx = box_mesh()
    ip = _acc(doc, bin_parts, p, target=34962)
    inn = _acc(doc, bin_parts, n, target=34962)
    ii = _acc(doc, bin_parts, np.asarray(idx, np.uint16), target=34963)
    # Target 0 "Angle": shear; target 1 "Thin": squash in x.
    d0 = np.zeros_like(p)
    d0[:, 0] = 0.4 * p[:, 1]
    dn0 = np.zeros_like(n)
    d1 = np.zeros_like(p)
    d1[:, 0] = -0.35 * p[:, 0]
    dn1 = np.zeros_like(n)
    i_d0 = _acc(doc, bin_parts, d0, target=34962)
    i_dn0 = _acc(doc, bin_parts, dn0, target=34962)
    i_d1 = _acc(doc, bin_parts, d1, target=34962)
    i_dn1 = _acc(doc, bin_parts, dn1, target=34962)
    times = np.linspace(0.0, 4.0, 9).astype(np.float32)
    w0 = np.abs(np.sin(times * np.pi / 4.0)).astype(np.float32)
    w1 = np.abs(np.cos(times * np.pi / 4.0)).astype(np.float32)
    weights = np.stack([w0, w1], -1).reshape(-1)
    it = _acc(doc, bin_parts, times)
    iw = _acc(doc, bin_parts, weights)
    doc["meshes"] = [
        {"name": "Cube",
         "primitives": [{
             "attributes": {"POSITION": ip, "NORMAL": inn},
             "indices": ii,
             "targets": [
                 {"POSITION": i_d0, "NORMAL": i_dn0},
                 {"POSITION": i_d1, "NORMAL": i_dn1},
             ],
         }],
         "weights": [0.0, 0.0],
         "extras": {"targetNames": ["Angle", "Thin"]}}
    ]
    doc["nodes"] = [
        {"mesh": 0, "rotation": [0.0, 0.0, 0.0, 1.0], "name": "AnimatedMorphCube"}
    ]
    doc["animations"] = [
        {"name": "Square",
         "samplers": [{"input": it, "output": iw, "interpolation": "LINEAR"}],
         "channels": [{"sampler": 0, "target": {"node": 0, "path": "weights"}}]}
    ]
    doc["scenes"] = [{"nodes": [0]}]
    blob = b"".join(bin_parts)
    doc["buffers"] = [{"byteLength": len(blob), "uri": _buf_uri(blob)}]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def write_multiuv_gltf(path, tex_size=32):
    """Multi-UV coverage: baseColor on TEXCOORD_0, occlusion on TEXCOORD_1
    (the common official-asset pattern the single-UV generators miss),
    plus a u16-NORMALIZED COLOR_0 accessor (Mesh.h vertex-color format)."""

    doc = {"asset": {"version": "2.0"}, "scene": 0}
    bin_parts = []
    p, n, uv, idx = box_mesh()
    uv1 = np.clip(uv * 0.5 + 0.25, 0.0, 1.0).astype(np.float32)
    col = np.full((len(p), 4), 65535, np.uint16)
    col[:, 1] = np.linspace(0, 65535, len(p)).astype(np.uint16)
    ip = _acc(doc, bin_parts, p, target=34962)
    inn = _acc(doc, bin_parts, n, target=34962)
    iuv0 = _acc(doc, bin_parts, uv, target=34962)
    iuv1 = _acc(doc, bin_parts, uv1, target=34962)
    icol = _acc(doc, bin_parts, col, target=34962, normalized=True)
    ii = _acc(doc, bin_parts, np.asarray(idx, np.uint16), target=34963)

    yy, xx = np.meshgrid(np.arange(tex_size), np.arange(tex_size), indexing="ij")
    base = np.stack([200 + 0 * xx, 120 + ((xx // 4) % 2) * 80, 60 + 0 * xx,
                     np.full_like(xx, 255)], -1).astype(np.uint8)
    occ = np.stack([(255 * (0.5 + 0.5 * yy / tex_size)).astype(np.uint8)] * 3
                   + [np.full_like(xx, 255).astype(np.uint8)], -1).astype(np.uint8)

    png = encode_png

    doc["images"] = []
    doc["textures"] = []
    for img in (png(base), png(occ)):
        off = sum(len(b) for b in bin_parts)
        padb = (-off) % 4
        if padb:
            bin_parts.append(b"\x00" * padb)
            off += padb
        bin_parts.append(img)
        doc["bufferViews"].append(
            {"buffer": 0, "byteOffset": off, "byteLength": len(img)})
        doc["images"].append(
            {"bufferView": len(doc["bufferViews"]) - 1, "mimeType": "image/png"})
        doc["textures"].append({"source": len(doc["images"]) - 1})
    doc["materials"] = [{
        "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0, "texCoord": 0},
            "roughnessFactor": 0.9,
        },
        "occlusionTexture": {"index": 1, "texCoord": 1},
    }]
    doc["meshes"] = [
        {"primitives": [{
            "attributes": {"POSITION": ip, "NORMAL": inn, "TEXCOORD_0": iuv0,
                           "TEXCOORD_1": iuv1, "COLOR_0": icol},
            "indices": ii, "material": 0}]}
    ]
    doc["nodes"] = [{"mesh": 0}]
    doc["scenes"] = [{"nodes": [0]}]
    blob = b"".join(bin_parts)
    doc["buffers"] = [{"byteLength": len(blob), "uri": _buf_uri(blob)}]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def write_camera_anim_gltf(path):
    """Box + glTF camera riding a translation-animated node.

    Exercises per-tick camera-from-node view derivation (Gltf.cpp:1015-1041
    node globals feeding Camera.h:70-73 SetWorldToView): at t=0 the camera is
    centered on the box; by t=1 it has panned +X so the box moves in frame.
    """
    doc = {"asset": {"version": "2.0"}, "scene": 0}
    bin_parts = []
    p, n, uv, idx = box_mesh()
    ip = _acc(doc, bin_parts, p, target=34962)
    inn = _acc(doc, bin_parts, n, target=34962)
    ii = _acc(doc, bin_parts, idx, target=34963)
    times = np.asarray([0.0, 1.0], np.float32)
    trans = np.asarray([[0.0, 0.0, 4.0], [2.0, 0.0, 4.0]], np.float32)
    it = _acc(doc, bin_parts, times)
    itr = _acc(doc, bin_parts, trans)
    doc["meshes"] = [
        {"primitives": [{"attributes": {"POSITION": ip, "NORMAL": inn}, "indices": ii, "material": 0}]}
    ]
    doc["materials"] = [
        {"pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.7, 0.2, 1.0], "roughnessFactor": 0.8}}
    ]
    doc["cameras"] = [
        {"type": "perspective", "perspective": {"yfov": 0.8, "znear": 0.01, "aspectRatio": 1.5}}
    ]
    doc["extensionsUsed"] = ["KHR_lights_punctual"]
    doc["extensions"] = {
        "KHR_lights_punctual": {
            "lights": [{"type": "point", "intensity": 60.0, "color": [1, 1, 1]}]
        }
    }
    doc["nodes"] = [
        {"mesh": 0, "name": "box"},
        {"camera": 0, "translation": [0.0, 0.0, 4.0], "name": "cam"},
        {
            "translation": [2.0, 3.0, 2.0],
            "extensions": {"KHR_lights_punctual": {"light": 0}},
            "name": "light",
        },
    ]
    doc["animations"] = [
        {
            "samplers": [{"input": it, "output": itr, "interpolation": "LINEAR"}],
            "channels": [{"sampler": 0, "target": {"node": 1, "path": "translation"}}],
        }
    ]
    doc["scenes"] = [{"nodes": [0, 1, 2]}]
    blob = b"".join(bin_parts)
    doc["buffers"] = [{"byteLength": len(blob), "uri": _buf_uri(blob)}]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def write_morph_gltf(path):
    """AnimatedMorphCube-style: box with one morph target + weight animation."""
    doc = {"asset": {"version": "2.0"}, "scene": 0}
    bin_parts = []
    p, n, uv, idx = box_mesh()
    ip = _acc(doc, bin_parts, p, target=34962)
    inn = _acc(doc, bin_parts, n, target=34962)
    ii = _acc(doc, bin_parts, idx, target=34963)
    delta = np.zeros_like(p)
    delta[:, 1] = 0.5 * p[:, 0] ** 2  # bulge
    imp = _acc(doc, bin_parts, delta, target=34962)
    times = np.asarray([0.0, 1.0, 2.0], np.float32)
    w = np.asarray([0.0, 1.0, 0.0], np.float32)
    it = _acc(doc, bin_parts, times)
    iw = _acc(doc, bin_parts, w)
    doc["meshes"] = [
        {
            "primitives": [
                {
                    "attributes": {"POSITION": ip, "NORMAL": inn},
                    "indices": ii,
                    "targets": [{"POSITION": imp}],
                }
            ],
            "weights": [0.0],
        }
    ]
    doc["nodes"] = [{"mesh": 0}]
    doc["animations"] = [
        {
            "samplers": [{"input": it, "output": iw, "interpolation": "LINEAR"}],
            "channels": [{"sampler": 0, "target": {"node": 0, "path": "weights"}}],
        }
    ]
    doc["scenes"] = [{"nodes": [0]}]
    blob = b"".join(bin_parts)
    doc["buffers"] = [{"byteLength": len(blob), "uri": _buf_uri(blob)}]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def write_materials_gltf(path):
    """DragonAttenuation/ToyCar-style material zoo: a transmissive+volume
    sphere, a clearcoat sphere, a sheen sphere, and an anisotropic metal
    sphere over an emissive-checker floor (BASELINE config 4)."""
    doc = {"asset": {"version": "2.0"}, "scene": 0}
    doc["extensionsUsed"] = [
        "KHR_materials_transmission", "KHR_materials_volume",
        "KHR_materials_clearcoat", "KHR_materials_sheen",
        "KHR_materials_anisotropy", "KHR_materials_ior",
        "KHR_materials_emissive_strength", "KHR_materials_specular",
    ]
    bin_parts = []
    sp, sn, suv, sidx = uv_sphere(24, 48)
    isp = _acc(doc, bin_parts, sp, target=34962)
    isn = _acc(doc, bin_parts, sn, target=34962)
    isuv = _acc(doc, bin_parts, suv, target=34962)
    isi = _acc(doc, bin_parts, sidx, target=34963)

    # Floor quad (y = -0.5 in glTF space).
    fp = np.asarray(
        [[-4, -0.5, -4], [4, -0.5, -4], [4, -0.5, 4], [-4, -0.5, 4]], np.float32
    )
    fn = np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1))
    fuv = np.asarray([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32)
    fidx = np.asarray([0, 2, 1, 0, 3, 2], np.uint16)
    ifp = _acc(doc, bin_parts, fp, target=34962)
    ifn = _acc(doc, bin_parts, fn, target=34962)
    ifuv = _acc(doc, bin_parts, fuv, target=34962)
    ifi = _acc(doc, bin_parts, fidx, target=34963)

    doc["materials"] = [
        {  # 0: transmissive glass with volume attenuation
            "pbrMetallicRoughness": {"baseColorFactor": [1, 1, 1, 1],
                                     "metallicFactor": 0.0, "roughnessFactor": 0.05},
            "extensions": {
                "KHR_materials_transmission": {"transmissionFactor": 1.0},
                "KHR_materials_volume": {"thicknessFactor": 0.5,
                                         "attenuationDistance": 0.5,
                                         "attenuationColor": [0.9, 0.4, 0.3]},
                "KHR_materials_ior": {"ior": 1.5},
            },
        },
        {  # 1: clearcoat car paint
            "pbrMetallicRoughness": {"baseColorFactor": [0.6, 0.05, 0.05, 1],
                                     "metallicFactor": 0.4, "roughnessFactor": 0.5},
            "extensions": {
                "KHR_materials_clearcoat": {"clearcoatFactor": 1.0,
                                            "clearcoatRoughnessFactor": 0.05},
            },
        },
        {  # 2: sheen velvet
            "pbrMetallicRoughness": {"baseColorFactor": [0.1, 0.1, 0.4, 1],
                                     "metallicFactor": 0.0, "roughnessFactor": 0.9},
            "extensions": {
                "KHR_materials_sheen": {"sheenColorFactor": [0.6, 0.5, 0.4],
                                        "sheenRoughnessFactor": 0.5},
            },
        },
        {  # 3: anisotropic brushed metal
            "pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.85, 0.7, 1],
                                     "metallicFactor": 1.0, "roughnessFactor": 0.3},
            "extensions": {
                "KHR_materials_anisotropy": {"anisotropyStrength": 0.8,
                                             "anisotropyRotation": 0.5},
            },
        },
        {  # 4: emissive checker floor (flat color; emissive strength)
            "pbrMetallicRoughness": {"baseColorFactor": [0.7, 0.7, 0.7, 1],
                                     "metallicFactor": 0.0, "roughnessFactor": 0.9},
            "extensions": {
                "KHR_materials_emissive_strength": {"emissiveStrength": 0.4},
            },
            "emissiveFactor": [1.0, 1.0, 1.0],
        },
    ]
    sphere_prim = {"attributes": {"POSITION": isp, "NORMAL": isn, "TEXCOORD_0": isuv},
                   "indices": isi}
    doc["meshes"] = [
        {"primitives": [dict(sphere_prim, material=0)]},
        {"primitives": [dict(sphere_prim, material=1)]},
        {"primitives": [dict(sphere_prim, material=2)]},
        {"primitives": [dict(sphere_prim, material=3)]},
        {"primitives": [{"attributes": {"POSITION": ifp, "NORMAL": ifn, "TEXCOORD_0": ifuv},
                         "indices": ifi, "material": 4}]},
    ]
    doc["nodes"] = [
        {"mesh": 0, "translation": [-1.8, 0, 0]},
        {"mesh": 1, "translation": [-0.6, 0, 0]},
        {"mesh": 2, "translation": [0.6, 0, 0]},
        {"mesh": 3, "translation": [1.8, 0, 0]},
        {"mesh": 4},
    ]
    doc["scenes"] = [{"nodes": [0, 1, 2, 3, 4]}]
    blob = b"".join(bin_parts)
    doc["buffers"] = [{"byteLength": len(blob), "uri": _buf_uri(blob)}]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def write_foliage_gltf(path, tex_size=64):
    """Sponza-foliage-style: alpha-MASKED leaf quads between a point light and
    a floor (tests any-hit rejection + alpha shadows; BASELINE config 5)."""

    doc = {"asset": {"version": "2.0"}, "scene": 0, "extensionsUsed": ["KHR_lights_punctual"]}
    bin_parts = []
    # Leaf texture: circular alpha holes.
    yy, xx = np.meshgrid(np.arange(tex_size), np.arange(tex_size), indexing="ij")
    cx = tex_size / 2
    r = np.sqrt((xx - cx) ** 2 + (yy - cx) ** 2)
    alpha = np.where((r % 16) < 8, 255, 0).astype(np.uint8)
    img = np.stack([np.full_like(alpha, 40), np.full_like(alpha, 160),
                    np.full_like(alpha, 40), alpha], -1)
    png = encode_png(img)

    # Leaf quad (vertical, XY plane).
    lp = np.asarray([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    ln = np.tile(np.asarray([[0, 0, 1]], np.float32), (4, 1))
    luv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    lidx = np.asarray([0, 1, 2, 0, 2, 3], np.uint16)
    ilp = _acc(doc, bin_parts, lp, target=34962)
    iln = _acc(doc, bin_parts, ln, target=34962)
    iluv = _acc(doc, bin_parts, luv, target=34962)
    ili = _acc(doc, bin_parts, lidx, target=34963)
    # Floor.
    fp = np.asarray([[-4, -2, -4], [4, -2, -4], [4, -2, 4], [-4, -2, 4]], np.float32)
    fn = np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1))
    fuv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    fidx = np.asarray([0, 2, 1, 0, 3, 2], np.uint16)
    ifp = _acc(doc, bin_parts, fp, target=34962)
    ifn = _acc(doc, bin_parts, fn, target=34962)
    ifuv = _acc(doc, bin_parts, fuv, target=34962)
    ifi = _acc(doc, bin_parts, fidx, target=34963)

    offset = sum(len(b) for b in bin_parts)
    pad = (-offset) % 4
    if pad:
        bin_parts.append(b"\x00" * pad)
        offset += pad
    bin_parts.append(png)
    doc["bufferViews"].append({"buffer": 0, "byteOffset": offset, "byteLength": len(png)})
    doc["images"] = [{"bufferView": len(doc["bufferViews"]) - 1, "mimeType": "image/png"}]
    doc["textures"] = [{"source": 0}]
    doc["materials"] = [
        {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                  "metallicFactor": 0.0, "roughnessFactor": 0.8},
         "alphaMode": "MASK", "alphaCutoff": 0.5, "doubleSided": True},
        {"pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.8, 0.8, 1],
                                  "metallicFactor": 0.0, "roughnessFactor": 0.9}},
    ]
    doc["meshes"] = [
        {"primitives": [{"attributes": {"POSITION": ilp, "NORMAL": iln, "TEXCOORD_0": iluv},
                         "indices": ili, "material": 0}]},
        {"primitives": [{"attributes": {"POSITION": ifp, "NORMAL": ifn, "TEXCOORD_0": ifuv},
                         "indices": ifi, "material": 1}]},
    ]
    doc["extensions"] = {"KHR_lights_punctual": {"lights": [
        {"type": "point", "intensity": 60.0, "color": [1, 1, 1]}
    ]}}
    doc["nodes"] = [
        {"mesh": 0, "translation": [0, 0, 0]},
        {"mesh": 1},
        {"translation": [0, 1.5, 2.5], "extensions": {"KHR_lights_punctual": {"light": 0}}},
    ]
    doc["scenes"] = [{"nodes": [0, 1, 2]}]
    blob = b"".join(bin_parts)
    doc["buffers"] = [{"byteLength": len(blob), "uri": _buf_uri(blob)}]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _quad_grid(origin, ax_u, ax_v, nu, nv):
    """Subdivided quad: origin + u*ax_u + v*ax_v, u,v in [0,1]. Returns
    (pos, normal, uv, idx)."""
    origin = np.asarray(origin, np.float32)
    ax_u = np.asarray(ax_u, np.float32)
    ax_v = np.asarray(ax_v, np.float32)
    uu, vv = np.meshgrid(
        np.linspace(0, 1, nu + 1, dtype=np.float32),
        np.linspace(0, 1, nv + 1, dtype=np.float32), indexing="ij",
    )
    p = origin[None, None] + uu[..., None] * ax_u + vv[..., None] * ax_v
    nrm = np.cross(ax_u, ax_v)
    nrm = nrm / max(np.linalg.norm(nrm), 1e-9)
    n = np.broadcast_to(nrm, p.shape).astype(np.float32)
    uv = np.stack([uu, vv], -1).astype(np.float32)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = (i * (nv + 1) + j).reshape(-1)
    b = ((i + 1) * (nv + 1) + j).reshape(-1)
    c = ((i + 1) * (nv + 1) + j + 1).reshape(-1)
    d = (i * (nv + 1) + j + 1).reshape(-1)
    idx = np.stack([a, b, c, a, c, d], 1).reshape(-1).astype(np.uint32)
    return p.reshape(-1, 3), n.reshape(-1, 3), uv.reshape(-1, 2), idx


def _cylinder(center, radius, height, n_seg, n_h):
    """Open cylinder around +Z. Returns (pos, normal, uv, idx)."""
    center = np.asarray(center, np.float32)
    th = np.linspace(0, 2 * np.pi, n_seg + 1, dtype=np.float32)
    z = np.linspace(0, height, n_h + 1, dtype=np.float32)
    tt, zz = np.meshgrid(th, z, indexing="ij")
    p = np.stack([
        center[0] + radius * np.cos(tt),
        center[1] + radius * np.sin(tt),
        center[2] + zz,
    ], -1).astype(np.float32)
    n = np.stack([np.cos(tt), np.sin(tt), np.zeros_like(tt)], -1).astype(np.float32)
    uv = np.stack([tt / (2 * np.pi), zz / height], -1).astype(np.float32)
    i, j = np.meshgrid(np.arange(n_seg), np.arange(n_h), indexing="ij")
    a = (i * (n_h + 1) + j).reshape(-1)
    b = ((i + 1) * (n_h + 1) + j).reshape(-1)
    c = ((i + 1) * (n_h + 1) + j + 1).reshape(-1)
    d = (i * (n_h + 1) + j + 1).reshape(-1)
    idx = np.stack([a, b, c, a, c, d], 1).reshape(-1).astype(np.uint32)
    return p.reshape(-1, 3), n.reshape(-1, 3), uv.reshape(-1, 2), idx


def write_plane_light_gltf(path, kind="directional", intensity=3.0,
                           half=20.0, base_color=(0.8, 0.6, 0.4, 1.0)):
    """Lambertian ground plane + ONE punctual light aimed straight down.

    Built for the closed-form absolute path-tracer tests: the quad lies in
    the glTF XZ plane (world XY after Y_UP_TO_Z_UP, normal world +Z) and
    the light axis is world -Z — directional via a -90-degree X rotation
    of the light node (glTF lights emit along node -Z, Lights.hlsli:26),
    point via a node at glTF (0, 8, 0) = world (0, 0, 8).
    """
    doc = {"asset": {"version": "2.0"}, "scene": 0}
    bin_parts = []
    s = float(half)
    p = np.asarray(
        [[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32)
    n = np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1))
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.asarray([0, 2, 1, 0, 3, 2], np.uint16)
    ip = _acc(doc, bin_parts, p, target=34962)
    inn = _acc(doc, bin_parts, n, target=34962)
    iuv = _acc(doc, bin_parts, uv, target=34962)
    ii = _acc(doc, bin_parts, idx, target=34963)
    doc["meshes"] = [{"primitives": [{
        "attributes": {"POSITION": ip, "NORMAL": inn, "TEXCOORD_0": iuv},
        "indices": ii, "material": 0,
    }]}]
    doc["materials"] = [{
        "pbrMetallicRoughness": {
            "baseColorFactor": list(base_color),
            "metallicFactor": 0.0,
            "roughnessFactor": 1.0,
        },
        # Zero the dielectric specular layer so the surface is EXACTLY
        # Lambertian (otherwise the 0.04-f0 Fresnel + GGX lobe shifts the
        # closed form by a channel-dependent ~1-2%).
        "extensions": {"KHR_materials_specular": {"specularFactor": 0.0}},
        "doubleSided": True,
    }]
    doc["extensionsUsed"] = ["KHR_lights_punctual", "KHR_materials_specular"]
    doc["extensions"] = {"KHR_lights_punctual": {"lights": [
        {"type": kind, "intensity": float(intensity), "color": [1, 1, 1]}
    ]}}
    r2 = float(np.sqrt(0.5))
    light_node = {"extensions": {"KHR_lights_punctual": {"light": 0}},
                  "name": "light"}
    if kind == "directional":
        light_node["rotation"] = [-r2, 0.0, 0.0, r2]   # -Z_local -> world -Z
    else:
        light_node["translation"] = [0.0, 8.0, 0.0]    # world (0, 0, 8)
    doc["nodes"] = [{"mesh": 0, "name": "plane"}, light_node]
    doc["scenes"] = [{"nodes": [0, 1]}]
    blob = b"".join(bin_parts)
    doc["buffers"] = [{"byteLength": len(blob), "uri": _buf_uri(blob)}]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def write_courtyard_glb(path, density=1, tex_size=256):
    """Sponza-class stress scene: colonnaded courtyard, ~290k tris at
    density=1 (~1.1M at density=2), 5 materials (stone floor/walls, marble
    pillars, metal spheres, alpha-MASKED fabric banners), 3 textures.

    Stands in for the Sponza atrium of BASELINE config 5 (no network access
    to glTF-Sample-Assets in this environment): large triangle count,
    multi-material, masked geometry for alpha shadows."""
    import struct

    rs = np.random.RandomState(11)
    d = density

    groups = {k: ([], [], [], []) for k in
              ("floor", "wall", "pillar", "metal", "banner")}

    def add(group, pos, n, uv, idx):
        ps, ns, uvs, idxs = groups[group]
        base = sum(p.shape[0] for p in ps)
        ps.append(pos); ns.append(n); uvs.append(uv); idxs.append(idx + base)

    # Floor 20x20, finely subdivided.
    add("floor", *_quad_grid([-10, -10, 0], [20, 0, 0], [0, 20, 0],
                             128 * d, 128 * d))
    # 4 walls, 6 high.
    for o, au in (([-10, -10, 0], [20, 0, 0]), ([10, 10, 0], [-20, 0, 0]),
                  ([10, -10, 0], [0, 20, 0]), ([-10, 10, 0], [0, -20, 0])):
        add("wall", *_quad_grid(o, au, [0, 0, 6], 128 * d, 64 * d))
    # Colonnade: 2 rows of 8 pillars.
    for row, y in ((0, -6.0), (1, 6.0)):
        for k in range(8):
            x = -8.4 + 2.4 * k
            add("pillar", *_cylinder([x, y, 0], 0.35, 5.0, 64 * d, 56 * d))
    # Metal spheres on pedestals.
    for k in range(6):
        p, n, uv, idx = uv_sphere(32 * d, 48 * d, radius=0.5)
        p = p + np.asarray([-7.5 + 3.0 * k, 0.0, 0.8], np.float32)
        add("metal", p, n, uv, idx)
    # Banners between pillars (double-sided masked quads).
    for k in range(7):
        x = -7.2 + 2.4 * k
        for y in (-6.0, 6.0):
            add("banner", *_quad_grid([x - 0.8, y, 4.6], [1.6, 0, 0],
                                      [0, 0, -2.2], 32 * d, 48 * d))

    doc = {"asset": {"version": "2.0"}, "scene": 0}
    bin_parts = []

    # Textures: stone checker, marble stripes, banner with cutout alpha.
    png_bytes = encode_png

    yy, xx = np.meshgrid(np.arange(tex_size), np.arange(tex_size), indexing="ij")
    checker = (((xx // 16) + (yy // 16)) % 2).astype(np.uint8)
    noise = rs.randint(0, 40, (tex_size, tex_size)).astype(np.uint8)
    stone = np.stack([150 + 30 * checker + noise // 2,
                      140 + 25 * checker + noise // 2,
                      125 + 20 * checker + noise // 2,
                      np.full_like(checker, 255)], -1).astype(np.uint8)
    stripes = (128 + 90 * np.sin(yy * 0.25 + 3 * np.sin(xx * 0.07))).astype(np.uint8)
    marble = np.stack([stripes, stripes, np.minimum(stripes + 20, 255),
                       np.full_like(stripes, 255)], -1).astype(np.uint8)
    # Banner: diamond cutout pattern (alpha mask) + red/gold weave.
    cx = np.abs((xx % 64) - 32) + np.abs((yy % 64) - 32)
    alpha = np.where(cx < 40, 255, 0).astype(np.uint8)
    banner = np.stack([200 + 0 * xx, 40 + ((xx // 8) % 2) * 120,
                       40 + 0 * xx, alpha], -1).astype(np.uint8)

    pngs = [png_bytes(stone), png_bytes(marble), png_bytes(banner)]
    doc["bufferViews"] = []
    doc["accessors"] = []

    mats = {
        "floor": {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                           "metallicFactor": 0.0, "roughnessFactor": 0.9}},
        "wall": {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                          "baseColorFactor": [0.9, 0.85, 0.8, 1.0],
                                          "metallicFactor": 0.0, "roughnessFactor": 0.85}},
        "pillar": {"pbrMetallicRoughness": {"baseColorTexture": {"index": 1},
                                            "metallicFactor": 0.05, "roughnessFactor": 0.4}},
        "metal": {"pbrMetallicRoughness": {"baseColorFactor": [0.95, 0.93, 0.88, 1.0],
                                           "metallicFactor": 1.0, "roughnessFactor": 0.15}},
        "banner": {"pbrMetallicRoughness": {"baseColorTexture": {"index": 2},
                                            "metallicFactor": 0.0, "roughnessFactor": 1.0},
                   "alphaMode": "MASK", "alphaCutoff": 0.5, "doubleSided": True},
    }
    order = list(groups.keys())
    doc["materials"] = [mats[k] for k in order]

    prims = []
    for mi, k in enumerate(order):
        ps, ns, uvs, idxs = groups[k]
        p = np.concatenate(ps); n = np.concatenate(ns)
        uv = np.concatenate(uvs); idx = np.concatenate(idxs)
        prims.append({
            "attributes": {
                "POSITION": _acc(doc, bin_parts, p, target=34962),
                "NORMAL": _acc(doc, bin_parts, n, target=34962),
                "TEXCOORD_0": _acc(doc, bin_parts, uv, target=34962),
            },
            "indices": _acc(doc, bin_parts, idx, target=34963),
            "material": mi,
        })

    doc["images"] = []
    doc["textures"] = []
    for png in pngs:
        offset = sum(len(b) for b in bin_parts)
        pad = (-offset) % 4
        if pad:
            bin_parts.append(b"\x00" * pad)
            offset += pad
        bin_parts.append(png)
        doc["bufferViews"].append({"buffer": 0, "byteOffset": offset,
                                   "byteLength": len(png)})
        doc["images"].append({"bufferView": len(doc["bufferViews"]) - 1,
                              "mimeType": "image/png"})
        doc["textures"].append({"source": len(doc["images"]) - 1, "sampler": 0})
    doc["samplers"] = [{"wrapS": 10497, "wrapT": 10497}]

    doc["meshes"] = [{"primitives": prims}]
    # Interior camera: at one end of the nave looking down the colonnade
    # (the classic Sponza view). -Z forward in glTF camera space; rotate so
    # forward is +X world with Z up: R = rot_z(-90deg) * rot_x(90deg).
    doc["cameras"] = [{"type": "perspective",
                       "perspective": {"yfov": 1.0472, "znear": 0.05}}]
    # The geometry above is authored directly in renderer world coordinates
    # (Z-up: floor at z=0, pillars along +z), but the loader applies the
    # reference's Y_UP_TO_Z_UP basis change at scene roots (Gltf.cpp:1017).
    # A compensating root rotation (-90 deg about X, the inverse: world =
    # Y_UP_TO_Z_UP @ R = identity) keeps the authored coordinates AS world
    # coordinates — without it the whole courtyard rendered lying on its
    # side (pillars horizontal, floor vertical; caught by the round-5
    # config-5 artifact).
    r2f = float(np.sqrt(0.5))
    doc["nodes"] = [
        {"rotation": [-r2f, 0.0, 0.0, r2f], "children": [1, 2],
         "name": "zup_root"},
        {"mesh": 0},
        {"camera": 0, "translation": [-9.0, 0.0, 1.7],
         "rotation": [0.5, -0.5, -0.5, 0.5]},
    ]
    doc["scenes"] = [{"nodes": [0]}]
    blob = b"".join(bin_parts)
    blob += b"\x00" * ((-len(blob)) % 4)
    doc["buffers"] = [{"byteLength": len(blob)}]

    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    glb = struct.pack("<III", 0x46546C67, 2, total)
    glb += struct.pack("<II", len(js), 0x4E4F534A) + js
    glb += struct.pack("<II", len(blob), 0x004E4942) + blob
    with open(path, "wb") as f:
        f.write(glb)
    return path
