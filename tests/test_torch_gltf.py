"""glTF scenes in the port against the JAX loader, on the CPU, with no JAX compile.

  * utils/png.py's reader against PIL's convert("RGBA") for each colour
    type it covers (gray, gray + alpha, RGB, RGBA, palette), with tRNS
    (gray key, RGB key, palette alphas), each of the five row filters
    alone and mixed, and PIL's own files; every other image (JPEG, 16-bit
    and interlaced PNG) goes to PIL and equals it;
  * core/scene.py's cv_resize against cv2.resize, bit for bit, over a grid
    of sizes (scales 0.3 to 3, odd and 1-pixel sides, shrink on one axis
    and growth on the other) with 1 and 4 channels under INTER_AREA and
    INTER_LINEAR; 12-channel area resizes (the atlas mips) against cv2, and
    where cv2 5 refuses more than 4 channels (off the integer-factor path)
    against cv2 on each 4-channel part;
  * load_gltf, flatten_asset and load_scene against JAX's, bit for bit, on
    a .gltf and a .glb written into tmp_path: two meshes under a TRS and
    matrix hierarchy, a sparse accessor, a data-URI buffer beside the
    external .bin, images as files, data URIs and (.glb) bufferViews, PNG
    with Paeth rows, a palette PNG with tRNS and a JPEG, primitives without
    NORMAL, TANGENT or TEXCOORD_0, a line primitive, normalized and
    interleaved attributes, samplers, doubleSided, a camera, maps of
    unequal sizes, with and without max_texture_dim; and a file without
    materials;
  * a fresh interpreter with PIL and cv2 blocked loads a PNG-textured
    scene, and names the image it cannot decode without PIL.
"""

import io
import itertools
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _pil_rgba(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _png_with_filters(samples: np.ndarray, ctype: int, filters, plte=None, trns=None, interlace=0) -> bytes:
    """An 8-bit PNG of samples [H, W, C] whose row y uses filters[y % len]
    (interlace=1 marks it Adam7, whose data equals the plain layout only
    for a 1x1 image)."""
    h, w, c = samples.shape
    img = samples.astype(np.int32)
    rows = []
    for y in range(h):
        f = filters[y % len(filters)]
        cur = img[y].reshape(-1)
        up = img[y - 1].reshape(-1) if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        rows.append(bytes([f]) + ((cur - pred) & 255).astype(np.uint8).tobytes())

    def chunk(t, p):
        return struct.pack(">I", len(p)) + t + p + struct.pack(">I", zlib.crc32(t + p))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, interlace))
    if plte is not None:
        out += chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b"")


CTYPES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
FILTERS = [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 3, 1)]


@pytest.mark.parametrize("ctype,filters", list(itertools.product(CTYPES, FILTERS)))
def test_png_reader_matches_pil(ctype, filters):
    from nebulae_tpu_torch.utils import png

    rng = np.random.default_rng(ctype * 10 + len(filters))
    for h, w in ((1, 1), (1, 9), (7, 1), (13, 17)):
        smooth = (np.arange(w)[None, :, None] * 7 + np.arange(h)[:, None, None] * 3) % 256
        s = ((smooth + rng.integers(0, 24, (h, w, CTYPES[ctype]))) % 256).astype(np.uint8)
        plte = trns = None
        if ctype == 3:
            s = (s % 50).astype(np.uint8)
            plte = rng.integers(0, 256, (50, 3))
            trns = rng.integers(0, 256, 30).astype(np.uint8).tobytes()  # shorter than the palette
        elif ctype == 0:
            trns = struct.pack(">H", int(s[0, 0, 0]))
        elif ctype == 2:
            trns = struct.pack(">HHH", *(int(v) for v in s[-1, -1]))
        for t in (None, trns):
            data = _png_with_filters(s, ctype, filters, plte, t)
            assert png.covers(data)
            np.testing.assert_array_equal(png.read_png(data), _pil_rgba(data))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_reader_on_pil_files(mode):
    """PIL's own encoder (adaptive filters, its palette and tRNS) read back."""
    from PIL import Image

    from nebulae_tpu_torch.utils import png

    rng = np.random.default_rng(len(mode))
    x = np.linspace(0, 255, 61)
    base = (np.add.outer(x, x[:45]) / 2 + rng.integers(0, 30, (61, 45))).astype(np.uint8)
    if mode == "P":
        rgba = np.stack([base, base[::-1], 255 - base, (base > 100) * 255], -1).astype(np.uint8)
        im = Image.fromarray(rgba, "RGBA").quantize(colors=200)
    else:
        c = len(mode)
        im = Image.fromarray(np.stack([base, 255 - base, base // 2, base[::-1]][:c], -1).squeeze(), mode)
    for kw in ({}, {"optimize": True}, {"transparency": 7} if mode in ("L", "P") else {}):
        buf = io.BytesIO()
        im.save(buf, format="PNG", **kw)
        data = buf.getvalue()
        assert png.covers(data)
        np.testing.assert_array_equal(png.read_png(data), _pil_rgba(data))


def test_png_writer_and_other_formats_through_pil():
    """encode_png round-trips RGB and RGBA through PIL; JPEG, 16-bit and
    interlaced PNG are not covered and decode through PIL, equal to it."""
    from PIL import Image

    from nebulae_tpu_torch.core.gltf import decode_image_bytes
    from nebulae_tpu_torch.utils import png

    rng = np.random.default_rng(3)
    for c in (3, 4):
        img = rng.integers(0, 256, (23, 31, c), dtype=np.uint8)
        data = png.encode_png(img)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
        np.testing.assert_array_equal(png.read_png(data)[..., :c], img)
    img = rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
    others = []
    for fmt, arr in (("JPEG", img), ("PNG", img[..., 0].astype(np.uint16) * 257)):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format=fmt)
        others.append(buf.getvalue())
    others.append(_png_with_filters(img[:1, :1], 2, (1,), interlace=1))
    with pytest.raises(ValueError):
        png.read_png(others[0])
    for data in others:
        assert not png.covers(data)
        np.testing.assert_array_equal(decode_image_bytes(data, "test image"), _pil_rgba(data))


# ---------------------------------------------------------------------------
# cv2.resize
# ---------------------------------------------------------------------------

SIDES = (1, 2, 3, 5, 8, 13, 31, 64, 75)
SCALES = ((0.3, 0.3), (0.5, 0.5), (0.7, 0.45), (1.0, 0.6), (0.6, 1.0), (1.5, 1.5), (2.0, 2.0), (3.0, 3.0),
          (0.5, 2.0), (2.3, 0.4), (1.7, 1.0), (0.34, 2.9))


@pytest.mark.parametrize("channels,interp", list(itertools.product((1, 4), ("area", "linear"))))
def test_resize_matches_cv2(channels, interp):
    import cv2

    from nebulae_tpu_torch.core.scene import INTER_AREA, INTER_LINEAR, cv_resize

    flag = {"area": (INTER_AREA, cv2.INTER_AREA), "linear": (INTER_LINEAR, cv2.INTER_LINEAR)}[interp]
    rng = np.random.default_rng(channels)
    n = 0
    for sh, sw in itertools.product(SIDES, SIDES):
        img = rng.integers(0, 256, (sh, sw, channels), dtype=np.uint8)
        src = img[..., 0] if channels == 1 else img
        for fy, fx in SCALES:
            h, w = max(1, int(sh * fy)), max(1, int(sw * fx))
            ref = cv2.resize(src, (w, h), interpolation=flag[1]).reshape(h, w, channels)
            got = cv_resize(src, h, w, flag[0])
            assert got.shape == (h, w, channels)
            np.testing.assert_array_equal(got, ref, err_msg=f"{(sh, sw)} -> {(h, w)}")
            n += 1
    assert n == len(SIDES) ** 2 * len(SCALES)


def test_resize_map_at_texture_sizes_and_twelve_channels():
    """The loader's resizes at real map sizes (a 2048 cap halving, a
    1000x750 map into a 1024 slot, a 512 normal map upsampled, a 1500 map
    capped to 1024) and 12-channel atlas mips (odd halvings included)
    against cv2 on each 4-channel part."""
    import cv2

    from nebulae_tpu_torch.core.scene import INTER_AREA, _resize_map, cv_resize

    rng = np.random.default_rng(5)
    for (sh, sw), (h, w) in (((2048, 2048), (1024, 1024)), ((750, 1000), (1024, 1024)),
                             ((512, 512), (1024, 1024)), ((1500, 1500), (1024, 1024)), ((750, 1000), (600, 1200))):
        img = rng.integers(0, 256, (sh, sw, 4), dtype=np.uint8)
        interp = cv2.INTER_AREA if (sh > h or sw > w) else cv2.INTER_LINEAR
        np.testing.assert_array_equal(_resize_map(img, h, w), cv2.resize(img, (w, h), interpolation=interp))
    for (sh, sw), (h, w) in (((64, 96), (32, 48)), ((375, 500), (187, 250)), ((93, 125), (46, 62)),
                             ((3, 1), (1, 1))):
        img = rng.integers(0, 256, (sh, sw, 12), dtype=np.uint8)
        try:  # cv2 takes 12 channels at integer factors only
            ref = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
            assert (sh % h, sw % w) == (0, 0)
        except cv2.error:
            ref = np.concatenate([cv2.resize(img[..., i:i + 4], (w, h), interpolation=cv2.INTER_AREA)
                                  .reshape(h, w, 4) for i in (0, 4, 8)], -1)
        np.testing.assert_array_equal(cv_resize(img, h, w, INTER_AREA), ref)


# ---------------------------------------------------------------------------
# glTF files against the JAX loader
# ---------------------------------------------------------------------------


def _maps(rng):
    """Maps of unequal sizes: PNG arrays, a PIL-written PNG (adaptive
    filters), a palette PNG with tRNS, and a JPEG."""
    from PIL import Image

    def smooth(h, w, c):
        y, x = np.mgrid[0:h, 0:w]
        base = (x * 255 // max(w - 1, 1) + y * 97 // max(h - 1, 1))[..., None] + np.arange(c) * 40
        return ((base + rng.integers(0, 12, (h, w, c))) % 256).astype(np.uint8)

    def encoded(img, fmt, **kw):
        buf = io.BytesIO()
        img.save(buf, format=fmt, **kw)
        return buf.getvalue()

    pal = Image.fromarray(smooth(24, 32, 3)).quantize(colors=64)
    return {
        "base": _png_with_filters(smooth(40, 56, 4), 6, (4, 3, 1, 0, 2)),
        "mr": encoded(Image.fromarray(smooth(64, 64, 3)), "PNG"),
        "normal": smooth(16, 16, 3),
        "emissive": encoded(pal, "PNG", transparency=3),
        "jpeg": encoded(Image.fromarray(smooth(32, 32, 3)), "JPEG", quality=90),
    }


def _write_feature_scene(path: Path, rng) -> Path:
    from nebulae_tpu_torch.utils.testscenes import GltfWriter, trs_matrix

    w = GltfWriter()
    maps = _maps(rng)
    clamp, mirror = w.add_sampler(33071), w.add_sampler(33648, 10497)
    tex = {k: w.add_texture(w.add_image(v, data_uri=(k == "normal")), clamp if k == "base" else None)
           for k, v in maps.items()}
    tex["mr_mirror"] = w.add_texture(w.doc["textures"][tex["mr"]]["source"], mirror)  # the same image, mirrored
    w.add_material({"name": "textured", "doubleSided": True,
                    "pbrMetallicRoughness": {"baseColorFactor": [0.9, 0.8, 0.7, 1.0], "metallicFactor": 0.3,
                                             "roughnessFactor": 0.6, "baseColorTexture": {"index": tex["base"]},
                                             "metallicRoughnessTexture": {"index": tex["mr"]}},
                    "normalTexture": {"index": tex["normal"]}})
    w.add_material({"pbrMetallicRoughness": {"baseColorTexture": {"index": tex["jpeg"]},
                                             "metallicRoughnessTexture": {"index": tex["mr_mirror"]}},
                    "emissiveTexture": {"index": tex["emissive"]}, "emissiveFactor": [1.0, 0.5, 0.25]})
    w.add_material({"pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.4, 0.9, 1.0]}})

    # Mesh 0: a grid (u16 indices, interleaved POSITION + NORMAL, normalized
    # u16 TEXCOORD_0, TANGENT) and the same grid with a sparse POSITION
    # accessor, no NORMAL and no TANGENT.
    n = 9
    gy, gx = np.mgrid[0:n, 0:n].astype(np.float32) / (n - 1)
    pos = np.stack([gx.ravel(), 0.1 * np.sin(6 * gx.ravel()) * gy.ravel(), gy.ravel()], -1).astype(np.float32)
    nrm = np.tile(np.float32([0, 1, 0]), (n * n, 1))
    quads = np.array([[i * n + j, i * n + j + 1, (i + 1) * n + j + 1, i * n + j, (i + 1) * n + j + 1, (i + 1) * n + j]
                      for i in range(n - 1) for j in range(n - 1)]).reshape(-1)
    uv16 = (np.stack([gx.ravel(), gy.ravel()], -1) * 65535 * 1.5).clip(0, 65535).astype(np.uint16)
    tan = np.tile(np.float32([1, 0, 0, -1]), (n * n, 1))
    p_acc, n_acc = w.add_interleaved([pos, nrm])
    grid = {"attributes": {"POSITION": p_acc, "NORMAL": n_acc, "TEXCOORD_0": w.add_accessor(uv16, normalized=True),
                           "TANGENT": w.add_accessor(tan)},
            "indices": w.add_accessor(quads.astype(np.uint16)), "material": 0}
    bump = np.arange(0, n * n, 7, dtype=np.uint32)
    sparse = {"attributes": {"POSITION": w.add_accessor(pos + np.float32([0, 0, 1.2]), minmax=True,
                                                        sparse=(bump, pos[bump] + np.float32([0, 0.3, 1.2]))),
                             "TEXCOORD_0": w.add_accessor(np.stack([gx.ravel(), gy.ravel()], -1) * 2.0)},
              "indices": w.add_accessor(quads.astype(np.uint32)), "material": 1}
    lines = {"attributes": {"POSITION": w.add_accessor(pos[:4])}, "mode": 1, "material": 2}
    mesh0 = w.add_mesh([grid, sparse, lines], "grids")

    # Mesh 1: an unindexed fan of triangles with no TEXCOORD_0, from a
    # data-URI buffer, and a primitive with no material given.
    rng_tris = rng.uniform(-0.5, 0.5, (60, 3)).astype(np.float32)
    fan = {"attributes": {"POSITION": w.add_accessor(rng_tris, data_uri=True),
                          "NORMAL": w.add_accessor(rng_tris / np.linalg.norm(rng_tris, axis=-1, keepdims=True),
                                                   data_uri=True)},
           "material": 2}
    bare = {"attributes": {"POSITION": w.add_accessor(rng_tris[:30] * 0.5)}}
    mesh1 = w.add_mesh([fan, bare], "fan")

    cam = w.add_camera({"type": "perspective", "perspective": {"yfov": 0.8, "znear": 0.01, "aspectRatio": 1.0}})
    inner = trs_matrix((0.2, 0.1, -0.3), (0.0, 0.0, np.sin(0.3), np.cos(0.3)), (1.0, 2.0, 0.5))
    a = w.add_node(mesh=mesh0, matrix=inner.T.reshape(-1).tolist(), name="grids")
    b = w.add_node(mesh=mesh1, translation=[1.5, 0.0, 0.0], rotation=[0.0, np.sin(0.4), 0.0, np.cos(0.4)],
                   scale=[0.7, 0.7, 0.7])
    c = w.add_node(camera=cam, translation=[0.0, 1.0, 4.0])
    d = w.add_node(mesh=mesh1, children=[c], translation=[-1.0, 0.5, 0.0])
    w.add_node(root=True, children=[a, b], translation=[0.1, 0.2, 0.3], rotation=[np.sin(0.1), 0.0, 0.0, np.cos(0.1)],
               scale=[1.5, 1.5, 1.5])
    w.add_node(root=True, children=[d])
    return w.save(path)


def _write_bare_scene(path: Path, rng) -> Path:
    """No materials, no images: one indexed primitive."""
    from nebulae_tpu_torch.utils.testscenes import GltfWriter

    w = GltfWriter()
    pos = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    prim = {"attributes": {"POSITION": w.add_accessor(pos)}, "indices": w.add_accessor(np.arange(30, dtype=np.uint8))}
    w.add_node(root=True, mesh=w.add_mesh([prim]))
    return w.save(path)


def _assert_assets_equal(p, j):
    assert len(p.instances) == len(j.instances) and len(p.materials) == len(j.materials)
    for a, b in zip(p.instances, j.instances, strict=True):
        np.testing.assert_array_equal(a.world, b.world)
        assert a.name == b.name and a.primitive.material == b.primitive.material
        for k in ("positions", "normals", "uvs", "tangents", "indices"):
            x, y = getattr(a.primitive, k), getattr(b.primitive, k)
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
    for a, b in zip(p.materials, j.materials, strict=True):
        for k, v in vars(b).items():
            np.testing.assert_array_equal(getattr(a, k), v, err_msg=k)
    assert len(p.images) == len(j.images)
    for a, b in zip(p.images, j.images, strict=True):
        np.testing.assert_array_equal(a, b)
    assert [sorted(c) for c in p.cameras] == [sorted(c) for c in j.cameras]
    for a, b in zip(p.cameras, j.cameras, strict=True):
        np.testing.assert_array_equal(a["world"], b["world"])
    np.testing.assert_array_equal(p.aabb_min, j.aabb_min)
    np.testing.assert_array_equal(p.aabb_max, j.aabb_max)


def _assert_flat_equal(p, j):
    for k, v in p.field_arrays().items():
        w = getattr(j, k)
        if v is None or w is None:
            assert v is None and w is None, k
            continue
        assert v.dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(v, w, err_msg=k)
    pa, ja = p.device_arrays(), j.device_arrays()
    assert set(pa) == set(ja)
    for k, v in pa.items():
        np.testing.assert_array_equal(v, np.asarray(ja[k]), err_msg=k)


@pytest.fixture(scope="module")
def feature_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gltf")
    return {suffix: _write_feature_scene(d / f"features{suffix}", np.random.default_rng(0))
            for suffix in (".gltf", ".glb")}


@pytest.mark.parametrize("suffix", [".gltf", ".glb"])
@pytest.mark.parametrize("max_dim", [None, 40])
def test_load_scene_matches_jax(feature_files, suffix, max_dim):
    from nebulae_tpu.core.scene import load_scene as jload

    from nebulae_tpu_torch.core.scene import load_scene

    path = feature_files[suffix]
    p, j = load_scene(path, max_texture_dim=max_dim), jload(path, max_texture_dim=max_dim)
    _assert_assets_equal(p.asset, j.asset)
    _assert_flat_equal(p.flat, j.flat)
    assert set(p.seconds) == {"parse_s", "decode_s", "pack_s"}
    fs = p.flat
    assert fs.num_materials == 3 and len(p.asset.cameras) == 1
    assert [inst.primitive.material for inst in p.asset.instances] == [0, 1, 2, 0, 2, 0]  # the line skipped
    assert fs.mat_flags[0] & 16 and not fs.mat_flags[1] & 16  # doubleSided
    assert len(set(map(tuple, fs.mat_tex_hw.tolist()))) > 1  # slots of unequal sizes


@pytest.mark.parametrize("suffix", [".gltf", ".glb"])
def test_gltf_pieces_match_jax(feature_files, suffix):
    """load_gltf (without images too) and flatten_asset on their own."""
    from nebulae_tpu.core.gltf import generate_tangents as jtangents
    from nebulae_tpu.core.gltf import load_gltf as jload_gltf
    from nebulae_tpu.core.gltf import node_local_matrix as jlocal
    from nebulae_tpu.core.scene import flatten_asset as jflatten

    from nebulae_tpu_torch.core.gltf import generate_tangents, load_gltf, node_local_matrix
    from nebulae_tpu_torch.core.scene import flatten_asset

    path = feature_files[suffix]
    p, j = load_gltf(path, load_images=False), jload_gltf(path, load_images=False)
    assert p.images == [] and j.images == []
    _assert_assets_equal(p, j)
    p, j = load_gltf(path), jload_gltf(path)
    _assert_flat_equal(flatten_asset(p, 24), jflatten(j, 24))
    for node in ({"matrix": list(range(16))}, {"translation": [1, 2, 3], "rotation": [0.1, 0.2, 0.3, 0.927],
                                                "scale": [1, 2, 3]}, {}):
        np.testing.assert_array_equal(node_local_matrix(node), jlocal(node))
    prim = p.instances[1].primitive
    np.testing.assert_array_equal(generate_tangents(prim.positions, prim.normals, prim.uvs, prim.indices),
                                  jtangents(prim.positions, prim.normals, prim.uvs, prim.indices))


@pytest.mark.parametrize("suffix", [".gltf", ".glb"])
def test_scene_without_materials_matches_jax(tmp_path, suffix):
    from nebulae_tpu.core.scene import load_scene as jload

    from nebulae_tpu_torch.core.scene import load_scene

    path = _write_bare_scene(tmp_path / f"bare{suffix}", np.random.default_rng(1))
    p, j = load_scene(path), jload(path)
    _assert_assets_equal(p.asset, j.asset)
    _assert_flat_equal(p.flat, j.flat)
    assert p.flat.num_materials == 1 and p.flat.textures.shape[0] == 0


def test_written_field_round_trips(tmp_path):
    """write_gltf of a procedural scene: both forms load to the same
    arrays, JAX's loader agrees, and the triangles come back to float32
    rounding of the node transforms."""
    from nebulae_tpu.core.scene import load_scene as jload

    from nebulae_tpu_torch.core.scene import load_scene
    from nebulae_tpu_torch.utils.testscenes import textured_scene, write_gltf

    fs = textured_scene(0)
    loaded = []
    for suffix in (".gltf", ".glb"):
        path = write_gltf(tmp_path / f"field{suffix}", fs)
        loaded.append(load_scene(path, max_texture_dim=48))
        _assert_flat_equal(loaded[-1].flat, jload(path, max_texture_dim=48).flat)
    _assert_flat_equal(loaded[0].flat, loaded[1].flat)
    got = loaded[0].flat
    np.testing.assert_array_equal(got.tri_mat, fs.tri_mat)
    np.testing.assert_allclose(got.tri_pos, fs.tri_pos, atol=2e-6)
    np.testing.assert_allclose(got.tri_nrm, fs.tri_nrm, atol=2e-6)


def test_loads_without_pil_or_cv2(tmp_path):
    """With PIL and cv2 blocked in sys.modules a PNG-textured scene loads
    (decode, caps and atlas), and a JPEG texture's error names the image."""
    from PIL import Image

    from nebulae_tpu_torch.utils.testscenes import GltfWriter, textured_scene, write_gltf

    write_gltf(tmp_path / "png.gltf", textured_scene(0))
    w = GltfWriter()
    buf = io.BytesIO()
    Image.fromarray(np.full((8, 8, 3), 90, np.uint8)).save(buf, format="JPEG")
    img = w.add_image(buf.getvalue(), name="bricks.jpg")
    w.add_material({"pbrMetallicRoughness": {"baseColorTexture": {"index": w.add_texture(img)}}})
    w.add_node(root=True, mesh=w.add_mesh([{"attributes": {"POSITION": w.add_accessor(np.eye(3, dtype=np.float32))},
                                            "material": 0}]))
    w.save(tmp_path / "jpeg.glb")
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\nsys.modules['cv2'] = None\n"
        "from nebulae_tpu_torch.core.scene import load_scene\n"
        f"s = load_scene({str(tmp_path / 'png.gltf')!r}, max_texture_dim=48)\n"
        "assert s.flat.num_triangles == 4928 and s.flat.mat_tex.shape[0] == 3, s.flat.mat_tex.shape\n"
        "s.flat.device_arrays()\n"
        "try:\n"
        f"    load_scene({str(tmp_path / 'jpeg.glb')!r})\n"
        "except ImportError as e:\n"
        "    assert 'bricks.jpg' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('a JPEG decoded without PIL')\n"
        "assert not any(m.startswith(('PIL.', 'cv2.')) for m in sys.modules)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
