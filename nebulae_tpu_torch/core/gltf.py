"""glTF 2.0 scene importer (Python, numpy and the port's PNG codec).

Counterpart of `nebulae_tpu/core/gltf.py`, line for line: every primitive
decodes into host numpy SoA arrays that `core.scene.flatten_asset` fuses
into the frame's tables.

Supported: .gltf with external .bin files or data URIs, the .glb container,
interleaved bufferViews (byteStride), sparse accessors, 8/16/32-bit
indices, normalized integer attributes, node TRS and matrix hierarchies,
pbrMetallicRoughness materials with base colour, metallic-roughness,
normal and emissive textures, sampler wrap modes, flat normals where NORMAL
is absent and tangent generation where TANGENT is absent.

Images: 8-bit, non-interlaced PNG decodes through `utils/png.py`; every
other image (JPEG, 16-bit or interlaced PNG, other formats) through PIL,
imported only then.  The header alone picks the path.
"""

from __future__ import annotations

import base64
import json
import struct
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from nebulae_tpu_torch.utils import png

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT2": 4, "MAT3": 9, "MAT4": 16}

# glTF sampler wrap modes
WRAP_REPEAT = 10497
WRAP_CLAMP = 33071
WRAP_MIRROR = 33648


@dataclass
class Primitive:
    """One drawable submesh: SoA attribute arrays (object space)."""

    positions: np.ndarray  # [V, 3] f32
    normals: np.ndarray  # [V, 3] f32
    uvs: np.ndarray  # [V, 2] f32
    tangents: np.ndarray  # [V, 4] f32 (xyz tangent, w handedness)
    indices: np.ndarray  # [I] u32
    material: int


@dataclass
class MaterialDesc:
    name: str = ""
    base_color_factor: np.ndarray = field(default_factory=lambda: np.ones(4, np.float32))
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    emissive_factor: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    base_color_tex: int = -1  # index into GLTFAsset.images
    metallic_roughness_tex: int = -1
    normal_tex: int = -1
    emissive_tex: int = -1
    wrap_mode: int = WRAP_REPEAT
    double_sided: bool = False


@dataclass
class MeshInstance:
    """A mesh primitive placed in the world by a node transform."""

    primitive: Primitive
    world: np.ndarray  # 4x4 f32, math convention (column vectors)
    name: str = ""


@dataclass
class GLTFAsset:
    instances: list[MeshInstance]
    materials: list[MaterialDesc]
    images: list[np.ndarray]  # decoded [H, W, 4] uint8, sRGB as stored
    cameras: list[dict]
    aabb_min: np.ndarray
    aabb_max: np.ndarray


# ---------------------------------------------------------------------------
# Buffer / accessor decoding
# ---------------------------------------------------------------------------


def _load_buffers(doc: dict, base_dir: Path, glb_bin: bytes | None) -> list[bytes]:
    out = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            out.append(glb_bin or b"")
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            from urllib.parse import unquote

            out.append((base_dir / unquote(uri)).read_bytes())
    return out


def _read_accessor(doc: dict, buffers: list[bytes], idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    n_comp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    itemsize = np.dtype(dtype).itemsize
    if "bufferView" not in acc:
        data = np.zeros((count, n_comp), dtype)
    else:
        bv = doc["bufferViews"][acc["bufferView"]]
        raw = buffers[bv["buffer"]]
        offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride") or n_comp * itemsize
        if stride == n_comp * itemsize:
            data = np.frombuffer(raw, dtype, count * n_comp, offset).reshape(count, n_comp)
        else:  # interleaved: gather each element's bytes, then reinterpret
            nbytes = stride * (count - 1) + n_comp * itemsize
            flat = np.frombuffer(raw, np.uint8, nbytes, offset)
            strided = np.lib.stride_tricks.as_strided(
                flat, shape=(count, n_comp * itemsize), strides=(stride, 1)
            )
            data = np.ascontiguousarray(strided).view(dtype).reshape(count, n_comp)
    if acc.get("sparse"):
        data = _apply_sparse(doc, buffers, acc, np.array(data))
    if acc.get("normalized") and np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        data = data.astype(np.float32) / float(info.max)
        if info.min < 0:
            data = np.maximum(data, -1.0)
    return data


def _apply_sparse(doc, buffers, acc, data):
    sp = acc["sparse"]
    n = sp["count"]
    idx_dtype = _COMPONENT_DTYPES[sp["indices"]["componentType"]]
    ibv = doc["bufferViews"][sp["indices"]["bufferView"]]
    ioff = ibv.get("byteOffset", 0) + sp["indices"].get("byteOffset", 0)
    idxs = np.frombuffer(buffers[ibv["buffer"]], idx_dtype, n, ioff).astype(np.int64)
    vbv = doc["bufferViews"][sp["values"]["bufferView"]]
    voff = vbv.get("byteOffset", 0) + sp["values"].get("byteOffset", 0)
    n_comp = _TYPE_COUNTS[acc["type"]]
    vals = np.frombuffer(
        buffers[vbv["buffer"]], _COMPONENT_DTYPES[acc["componentType"]], n * n_comp, voff
    ).reshape(n, n_comp)
    data[idxs] = vals
    return data


# ---------------------------------------------------------------------------
# Node transforms
# ---------------------------------------------------------------------------


def _quat_to_mat3(q: np.ndarray) -> np.ndarray:
    x, y, z, w = (float(v) for v in q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


def node_local_matrix(node: dict) -> np.ndarray:
    """Local transform in math (column-vector) convention.

    glTF stores `matrix` column-major flat; the reference transposes into its
    row-major convention (GLTFSceneImporter.cpp:777-802) -- we instead reshape
    column-major directly into the math convention.
    """
    if "matrix" in node:
        return np.array(node["matrix"], np.float64).reshape(4, 4, order="F")
    m = np.eye(4)
    t = node.get("translation", [0, 0, 0])
    r = node.get("rotation", [0, 0, 0, 1])
    s = node.get("scale", [1, 1, 1])
    m[:3, :3] = _quat_to_mat3(np.asarray(r)) @ np.diag(np.asarray(s, np.float64))
    m[:3, 3] = t
    return m


# ---------------------------------------------------------------------------
# Tangent generation (when TANGENT missing)
# ---------------------------------------------------------------------------


def generate_tangents(pos: np.ndarray, normal: np.ndarray, uv: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Per-vertex MikkTSpace-style tangents: accumulate per-triangle tangent /
    bitangent from UV derivatives, Gram-Schmidt against the normal, w =
    handedness sign.  Mirrors the behaviour of the reference's CPU pass
    (GLTFSceneImporter.cpp:622-727), fully vectorized."""
    v = pos.astype(np.float64)
    t = uv.astype(np.float64)
    i0, i1, i2 = idx[0::3].astype(np.int64), idx[1::3].astype(np.int64), idx[2::3].astype(np.int64)
    e1, e2 = v[i1] - v[i0], v[i2] - v[i0]
    du1, dv1 = t[i1, 0] - t[i0, 0], t[i1, 1] - t[i0, 1]
    du2, dv2 = t[i2, 0] - t[i0, 0], t[i2, 1] - t[i0, 1]
    det = du1 * dv2 - du2 * dv1
    r = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / np.where(det == 0, 1.0, det))[:, None]
    tan = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r
    bit = (e2 * du1[:, None] - e1 * du2[:, None]) * r
    acc_t = np.zeros_like(v)
    acc_b = np.zeros_like(v)
    for tri_ids in (i0, i1, i2):
        np.add.at(acc_t, tri_ids, tan)
        np.add.at(acc_b, tri_ids, bit)
    n = normal.astype(np.float64)
    # Gram-Schmidt orthogonalize, then handedness from bitangent direction.
    tang = acc_t - n * (n * acc_t).sum(-1, keepdims=True)
    norm = np.linalg.norm(tang, axis=-1, keepdims=True)
    fallback = np.where(
        np.abs(n[:, 0:1]) < 0.9,
        np.cross(n, np.array([1.0, 0, 0]))[:, :],
        np.cross(n, np.array([0, 1.0, 0]))[:, :],
    )
    tang = np.where(norm > 1e-8, tang / np.maximum(norm, 1e-12), fallback)
    w = np.where((np.cross(n, tang) * acc_b).sum(-1) < 0.0, -1.0, 1.0)
    return np.concatenate([tang, w[:, None]], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# Images
# ---------------------------------------------------------------------------


def _image_bytes(doc: dict, buffers: list[bytes], base_dir: Path, img: dict) -> tuple[bytes, str]:
    """An image's encoded bytes and a name for messages."""
    if "uri" in img:
        uri = img["uri"]
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1]), img.get("name") or "data URI image"
        from urllib.parse import unquote

        path = base_dir / unquote(uri)
        return path.read_bytes(), str(path)
    bv = doc["bufferViews"][img["bufferView"]]
    off = bv.get("byteOffset", 0)
    name = img.get("name") or f"image in bufferView {img['bufferView']}"
    return buffers[bv["buffer"]][off: off + bv["byteLength"]], name


def decode_image_bytes(raw: bytes, name: str) -> np.ndarray:
    """Encoded image -> [H, W, 4] uint8 RGBA, as PIL's convert("RGBA")."""
    if png.covers(raw):
        return png.read_png(raw)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"decoding {name} needs PIL: only 8-bit, non-interlaced PNG decodes "
                          "without it") from e
    import io

    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"), np.uint8)


def _decode_image(doc: dict, buffers: list[bytes], base_dir: Path, img: dict) -> np.ndarray:
    return decode_image_bytes(*_image_bytes(doc, buffers, base_dir, img))


# ---------------------------------------------------------------------------
# Top-level load
# ---------------------------------------------------------------------------


def _parse_glb(data: bytes) -> tuple[dict, bytes | None]:
    magic, _ver, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    off, doc, binary = 12, None, None
    while off < len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        payload = data[off + 8 : off + 8 + clen]
        if ctype == 0x4E4F534A:  # 'JSON'
            doc = json.loads(payload)
        elif ctype == 0x004E4942:  # 'BIN'
            binary = payload
        off += 8 + clen + (-clen) % 4  # chunks are 4-byte aligned
    return doc, binary


def load_gltf(path: str | Path, load_images: bool = True, timings: dict | None = None) -> GLTFAsset:
    """Load a .gltf/.glb file into a GLTFAsset (everything host-side numpy).
    A `timings` dict receives the seconds spent decoding images
    ("decode_s") and the rest of the load ("parse_s")."""
    t_start = time.perf_counter()
    path = Path(path)
    base_dir = path.parent
    raw = path.read_bytes()
    if raw[:4] == b"glTF":
        doc, glb_bin = _parse_glb(raw)
    else:
        doc, glb_bin = json.loads(raw), None
    buffers = _load_buffers(doc, base_dir, glb_bin)

    # Materials
    materials: list[MaterialDesc] = []
    tex_to_image = [t.get("source", -1) for t in doc.get("textures", [])]
    tex_to_sampler = [t.get("sampler", -1) for t in doc.get("textures", [])]
    samplers = doc.get("samplers", [])

    def tex_image(tinfo) -> int:
        if tinfo is None:
            return -1
        return tex_to_image[tinfo["index"]]

    def tex_wrap(tinfo) -> int:
        if tinfo is None:
            return WRAP_REPEAT
        s = tex_to_sampler[tinfo["index"]]
        if s < 0 or s >= len(samplers):
            return WRAP_REPEAT
        return samplers[s].get("wrapS", WRAP_REPEAT)

    for m in doc.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        md = MaterialDesc(
            name=m.get("name", ""),
            base_color_factor=np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32),
            metallic_factor=float(pbr.get("metallicFactor", 1.0)),
            roughness_factor=float(pbr.get("roughnessFactor", 1.0)),
            emissive_factor=np.asarray(m.get("emissiveFactor", [0, 0, 0]), np.float32),
            base_color_tex=tex_image(pbr.get("baseColorTexture")),
            metallic_roughness_tex=tex_image(pbr.get("metallicRoughnessTexture")),
            normal_tex=tex_image(m.get("normalTexture")),
            emissive_tex=tex_image(m.get("emissiveTexture")),
            wrap_mode=tex_wrap(pbr.get("baseColorTexture")),
            double_sided=bool(m.get("doubleSided", False)),
        )
        materials.append(md)
    if not materials:
        materials.append(MaterialDesc(name="default", metallic_factor=0.0, roughness_factor=1.0))

    # Images
    images: list[np.ndarray] = []
    t_decode = time.perf_counter()
    if load_images:
        for img in doc.get("images", []):
            images.append(_decode_image(doc, buffers, base_dir, img))
    t_decode = time.perf_counter() - t_decode

    # Primitives (decoded lazily per mesh, cached)
    prim_cache: dict[tuple[int, int], Primitive | None] = {}

    def get_primitive(mesh_idx: int, prim_idx: int) -> Primitive | None:
        key = (mesh_idx, prim_idx)
        if key in prim_cache:
            return prim_cache[key]
        prim = doc["meshes"][mesh_idx]["primitives"][prim_idx]
        if prim.get("mode", 4) != 4:  # triangles only
            prim_cache[key] = None
            return None
        attrs = prim["attributes"]
        pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
        nv = pos.shape[0]
        if "indices" in prim:
            idx = _read_accessor(doc, buffers, prim["indices"]).reshape(-1).astype(np.uint32)
        else:
            idx = np.arange(nv, dtype=np.uint32)
        if "NORMAL" in attrs:
            nrm = _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
        else:  # flat normals from faces
            nrm = np.zeros_like(pos)
            f = idx.reshape(-1, 3).astype(np.int64)
            fn = np.cross(pos[f[:, 1]] - pos[f[:, 0]], pos[f[:, 2]] - pos[f[:, 0]])
            for k in range(3):
                np.add.at(nrm, f[:, k], fn)
            nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
        uv = (
            _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
            if "TEXCOORD_0" in attrs
            else np.zeros((nv, 2), np.float32)
        )
        if "TANGENT" in attrs:
            tan = _read_accessor(doc, buffers, attrs["TANGENT"]).astype(np.float32)
        else:
            tan = generate_tangents(pos, nrm, uv, idx)
        p = Primitive(pos, nrm, uv, tan, idx, prim.get("material", 0))
        prim_cache[key] = p
        return p

    # Walk node hierarchy
    instances: list[MeshInstance] = []
    cameras: list[dict] = []
    scene = doc.get("scenes", [{}])[doc.get("scene", 0)]

    def walk(node_idx: int, parent: np.ndarray):
        node = doc["nodes"][node_idx]
        world = parent @ node_local_matrix(node)
        if "mesh" in node:
            mesh_idx = node["mesh"]
            for pi in range(len(doc["meshes"][mesh_idx]["primitives"])):
                p = get_primitive(mesh_idx, pi)
                if p is not None:
                    instances.append(
                        MeshInstance(p, world.astype(np.float32), node.get("name", ""))
                    )
        if "camera" in node:
            cam = dict(doc.get("cameras", [{}])[node["camera"]])
            cam["world"] = world.astype(np.float32)
            cameras.append(cam)
        for c in node.get("children", []):
            walk(c, world)

    for root in scene.get("nodes", []):
        walk(root, np.eye(4))

    # World AABB (POSITION min/max transformed, like GLTFSceneImporter.cpp:518-540)
    lo = np.full(3, np.inf, np.float32)
    hi = np.full(3, -np.inf, np.float32)
    for inst in instances:
        p = inst.primitive.positions @ inst.world[:3, :3].T + inst.world[:3, 3]
        lo = np.minimum(lo, p.min(axis=0))
        hi = np.maximum(hi, p.max(axis=0))

    if timings is not None:
        timings["decode_s"] = t_decode
        timings["parse_s"] = time.perf_counter() - t_start - t_decode
    return GLTFAsset(instances, materials, images, cameras, lo, hi)
