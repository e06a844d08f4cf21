"""Scene authoring API + packed device scene (torch port of
``ascii_renderer_tpu/scene/builder.py``; ref: js/render/scene_api.js).

``SceneBuilder`` mirrors the reference's authoring surface (materials
table with conventional uint IDs, spheres / tris / quads / planes with
uint16 texel UVs, meshes, env + area + point + directional lights, camera
pose, atlas descriptor, caps) and its JSON-able unified schema
(``to_unified`` / ``from_object``, the same dict as the JAX package's, so
a scene file written by either package loads in the other).

``SceneData`` keeps every field of the JAX pytree, as tensors, so
``tessellate_scene``, the raster shading, the path tracer's packer and
``utils.from_jax`` see one schema.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ascii_renderer_tpu_torch.core.camera import Camera


class MaterialIds:
    """Conventional material IDs (scene_api.js:11-19)."""

    LIGHT = 0
    WHITE = 1
    GREEN = 2
    RED = 3
    GLASS = 6
    MIRROR = 7


DEFAULT_MAT_ID = MaterialIds.WHITE


def _u32(x) -> int:
    try:
        n = math.floor(float(x))
    except (TypeError, ValueError):
        return 0
    if not math.isfinite(n) or n < 0:
        return 0
    return int(n) & 0xFFFFFFFF


def _u16(x) -> int:
    n = int(x)
    return 0 if n < 0 else (0xFFFF if n > 0xFFFF else n)


def _v3(v) -> List[float]:
    return [float(v[0]), float(v[1]), float(v[2])]


@dataclasses.dataclass
class Material:
    """ref: _mkMaterial, scene_api.js:39-50."""

    name: str = ""
    albedo: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    emissive: bool = False
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    reflective: bool = False
    roughness: float = 0.0

    def clamped(self) -> "Material":
        a = tuple(min(1.0, max(0.0, float(v))) for v in self.albedo)
        return dataclasses.replace(
            self, albedo=a, emission=tuple(float(v) for v in self.emission),
            roughness=min(1.0, max(0.0, float(self.roughness))))


def _round_up(n: int, m: int = 8) -> int:
    return max(m, ((n + m - 1) // m) * m)


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Packed device scene: padded struct-of-arrays (field-for-field the JAX
    ``SceneData``). Counts are 0-d int32 tensors; capacities are shapes."""

    sph_pos: torch.Tensor  # f32 [S, 3]
    sph_rad: torch.Tensor  # f32 [S]
    sph_mat: torch.Tensor  # i32 [S]
    n_sph: torch.Tensor

    tri_a: torch.Tensor  # f32 [T, 3]
    tri_b: torch.Tensor
    tri_c: torch.Tensor
    tri_mat: torch.Tensor  # i32 [T]
    tri_uva: torch.Tensor  # f32 [T, 2]
    tri_uvb: torch.Tensor
    tri_uvc: torch.Tensor
    n_tri: torch.Tensor

    quad_a: torch.Tensor  # f32 [Q, 3]
    quad_b: torch.Tensor
    quad_c: torch.Tensor
    quad_d: torch.Tensor
    quad_mat: torch.Tensor  # i32 [Q]
    quad_uv0: torch.Tensor  # f32 [Q, 2]
    quad_uv1: torch.Tensor
    quad_uv2: torch.Tensor
    quad_uv3: torch.Tensor
    n_quad: torch.Tensor

    pln_n: torch.Tensor  # f32 [P, 3]
    pln_d: torch.Tensor  # f32 [P]
    pln_mat: torch.Tensor  # i32 [P]
    n_pln: torch.Tensor

    mat_albedo: torch.Tensor  # f32 [M, 3]
    mat_emissive: torch.Tensor  # bool [M]
    mat_emission: torch.Tensor  # f32 [M, 3]
    mat_reflective: torch.Tensor  # bool [M]
    mat_roughness: torch.Tensor  # f32 [M]

    env_color: torch.Tensor  # f32 [3]
    env_intensity: torch.Tensor  # f32
    area_center: torch.Tensor  # f32 [3]
    area_radius: torch.Tensor  # f32
    area_auto: torch.Tensor  # bool
    pt_pos: torch.Tensor  # f32 [PL, 3] point lights
    pt_col: torch.Tensor  # f32 [PL, 3] (intensity premultiplied)
    n_pt: torch.Tensor
    dl_dir: torch.Tensor  # f32 [DL, 3] direction light TRAVELS
    dl_col: torch.Tensor  # f32 [DL, 3] (premultiplied)
    n_dl: torch.Tensor

    camera: Camera

    atlas_rgb: torch.Tensor  # u8 [AH, AW, 3]
    atlas_a: torch.Tensor  # u8 [AH, AW]

    @property
    def atlas_enabled(self) -> bool:
        return self.atlas_rgb.shape[0] > 1 and self.atlas_rgb.shape[1] > 1

    def _live(self, arr, n):
        return torch.arange(arr.shape[0], device=arr.device) < n

    def sph_valid(self):
        return self._live(self.sph_pos, self.n_sph)

    def tri_valid(self):
        return self._live(self.tri_a, self.n_tri)

    def quad_valid(self):
        return self._live(self.quad_a, self.n_quad)

    def pln_valid(self):
        return self._live(self.pln_n, self.n_pln)


class SceneBuilder:
    """Fluent scene authoring (scene_api.js:52-258)."""

    def __init__(self, max_spheres: int = 64, max_tris: int = 4096,
                 max_quads: int = 4096, max_planes: int = 64):
        self._max_s = int(max_spheres)
        self._max_t = int(max_tris)
        self._max_q = int(max_quads)
        self._max_p = int(max_planes)

        self._materials: Dict[int, Material] = {}
        self._spheres: List[dict] = []
        self._tris: List[dict] = []
        self._quads: List[dict] = []
        self._planes: List[dict] = []
        self._point_lights: List[dict] = []
        self._dir_lights: List[dict] = []
        self._atlas_pixels: Optional[np.ndarray] = None  # u8 [H, W, 4]
        self._atlas_size = (0, 0)
        self._env = {"color": [0.0, 0.0, 0.0], "intensity": 0.0}
        self._area = {"center": [3.0, 2.8, 3.0], "radius": 0.5, "auto": True}
        self._camera = {"pos": [2.78, 2.73, -8.00], "yaw": 0.0, "pitch": 0.0,
                        "fovY": 80 * math.pi / 180}

        # Default material table (scene_api.js:81-86).
        self.add_material(MaterialIds.LIGHT, Material(
            "LIGHT", (1, 1, 1), True, (16.86, 10.76, 8.2), False, 0.0))
        self.add_material(MaterialIds.WHITE, Material(
            "WHITE", (0.7295, 0.7355, 0.7290), False, (0, 0, 0), False, 0.6))
        self.add_material(MaterialIds.GREEN, Material(
            "GREEN", (0.1170, 0.4125, 0.1150), False, (0, 0, 0), False, 0.6))
        self.add_material(MaterialIds.RED, Material(
            "RED", (0.6110, 0.0555, 0.0620), False, (0, 0, 0), False, 0.6))
        self.add_material(MaterialIds.GLASS, Material(
            "GLASS", (1, 1, 1), False, (0, 0, 0), True, 0.0))
        self.add_material(MaterialIds.MIRROR, Material(
            "MIRROR", (1, 1, 1), False, (0, 0, 0), True, 0.0))

    def add_material(self, mat_id, mat: Material | dict) -> int:
        mid = _u32(mat_id)
        if isinstance(mat, dict):
            mat = Material(**{k: v for k, v in mat.items()
                              if k in Material.__dataclass_fields__})
        self._materials[mid] = mat.clamped()
        return mid

    def has_material(self, mat_id) -> bool:
        return _u32(mat_id) in self._materials

    def get_material(self, mat_id) -> Optional[Material]:
        return self._materials.get(_u32(mat_id))

    def _resolve_mat(self, mat_id) -> int:
        """Unknown/None ids coerce through _u32 exactly like the JS
        (`undefined` -> 0 -> LIGHT exists -> used!), else fall back to WHITE
        (scene_api.js:133)."""
        mid = _u32(mat_id)
        return mid if mid in self._materials else DEFAULT_MAT_ID

    def set_camera_pose(self, pos=(2.78, 2.73, -8.00), *, yaw=0.0, pitch=0.0,
                        fovy_deg=80.0) -> "SceneBuilder":
        pos = _v3(pos)
        if not all(math.isfinite(v) for v in pos + [yaw, pitch]):
            raise ValueError("set_camera_pose: bad args")
        self._camera = {"pos": pos, "yaw": float(yaw), "pitch": float(pitch),
                        "fovY": float(fovy_deg) * math.pi / 180.0}
        return self

    def set_env_light(self, color=(0, 0, 0), intensity=0.0) -> "SceneBuilder":
        self._env = {"color": _v3(color), "intensity": float(intensity)}
        return self

    def set_area_light(self, center=(3, 2.8, 3), radius=0.5, *,
                       auto=True) -> "SceneBuilder":
        self._area = {"center": _v3(center), "radius": float(radius),
                      "auto": bool(auto)}
        return self

    def add_point_light(self, pos, color=(1, 1, 1), intensity=1.0) -> "SceneBuilder":
        self._point_lights.append({"p": _v3(pos), "color": _v3(color),
                                   "intensity": float(intensity)})
        return self

    def add_dir_light(self, direction, color=(1, 1, 1), intensity=1.0) -> "SceneBuilder":
        self._dir_lights.append({"dir": _v3(direction), "color": _v3(color),
                                 "intensity": float(intensity)})
        return self

    def set_texture_atlas_size(self, width: int,
                               height: int) -> "SceneBuilder":
        self._atlas_size = (max(0, int(width)), max(0, int(height)))
        return self

    def set_atlas(self, pixels: np.ndarray) -> "SceneBuilder":
        """Attach ASCII-texture atlas pixels, u8 [H, W, 4], (0,0) = top-left
        (the atlas_paint.py file format; loaded via atlas.io)."""
        pixels = np.asarray(pixels, dtype=np.uint8)
        assert pixels.ndim == 3 and pixels.shape[2] == 4
        self._atlas_pixels = pixels
        self._atlas_size = (pixels.shape[1], pixels.shape[0])
        return self

    def add_sphere(self, center=(0, 0, 0), radius=1.0,
                   material_id=DEFAULT_MAT_ID) -> "SceneBuilder":
        center = _v3(center)
        if not all(math.isfinite(v) for v in center + [radius]):
            raise ValueError("add_sphere: bad args")
        if len(self._spheres) >= self._max_s:
            return self
        self._spheres.append({"p": center, "r": float(radius),
                              "matId": self._resolve_mat(material_id)})
        return self

    def add_triangle(self, a=(0, 0, 0), b=(1, 0, 0), c=(0, 1, 0),
                     material_id=DEFAULT_MAT_ID,
                     uv_a=(0, 0), uv_b=(0, 0), uv_c=(0, 0)) -> "SceneBuilder":
        a, b, c = _v3(a), _v3(b), _v3(c)
        if not all(math.isfinite(v) for v in a + b + c):
            raise ValueError("add_triangle: bad args")
        if len(self._tris) >= self._max_t:
            return self
        u = lambda uv: [_u16(uv[0] or 0), _u16(uv[1] or 0)]  # noqa: E731
        self._tris.append({"a": a, "b": b, "c": c,
                           "matId": self._resolve_mat(material_id),
                           "uvA": u(uv_a), "uvB": u(uv_b), "uvC": u(uv_c)})
        return self

    def add_quad(self, a=(0, 0, 0), b=(1, 0, 0), c=(1, 1, 0), d=(0, 1, 0),
                 material_id=DEFAULT_MAT_ID, uv0=(0, 0), uv1=(0, 0),
                 uv2=(0, 0), uv3=(0, 0)) -> "SceneBuilder":
        a, b, c, d = _v3(a), _v3(b), _v3(c), _v3(d)
        if not all(math.isfinite(v) for v in a + b + c + d):
            raise ValueError("add_quad: bad args")
        if len(self._quads) >= self._max_q:
            return self
        u = lambda uv: [_u16(uv[0] or 0), _u16(uv[1] or 0)]  # noqa: E731
        self._quads.append({"a": a, "b": b, "c": c, "d": d,
                            "matId": self._resolve_mat(material_id),
                            "uv0": u(uv0), "uv1": u(uv1), "uv2": u(uv2),
                            "uv3": u(uv3)})
        return self

    def add_rect(self, p00, p10, p11, p01, material_id=DEFAULT_MAT_ID,
                 uv00=(0, 0), uv10=(0, 0), uv11=(0, 0),
                 uv01=(0, 0)) -> "SceneBuilder":
        return self.add_quad(p00, p10, p11, p01, material_id, uv00, uv10,
                             uv11, uv01)

    def add_plane(self, normal=(0, 1, 0), d=0.0,
                  material_id=DEFAULT_MAT_ID) -> "SceneBuilder":
        n = np.asarray(_v3(normal), dtype=np.float64)
        ln = float(np.linalg.norm(n)) or 1.0
        if len(self._planes) >= self._max_p:
            return self
        self._planes.append({"n": (n / ln).tolist(), "d": float(d),
                             "matId": self._resolve_mat(material_id)})
        return self

    def add_mesh(self, positions: Sequence[float], indices=None, uvs=None,
                 material_id=DEFAULT_MAT_ID) -> "SceneBuilder":
        """Triangle soup / indexed mesh helper (scene_api.js:169-192):
        flat xyz positions; indexed triangles with an index out of range
        are skipped; uvs are flat per-vertex u16 texel pairs."""
        positions = list(positions)
        if len(positions) % 3 != 0:
            return self
        nverts = len(positions) // 3
        get_v = lambda i: positions[3 * i: 3 * i + 3]  # noqa: E731

        def get_uv(i):
            if not uvs or len(uvs) < 2 * (i + 1):
                return (0, 0)
            return (_u16(int(uvs[2 * i])), _u16(int(uvs[2 * i + 1])))

        if indices is not None and len(indices) % 3 == 0:
            for t in range(0, len(indices), 3):
                i0, i1, i2 = (int(indices[t]), int(indices[t + 1]),
                              int(indices[t + 2]))
                if min(i0, i1, i2) < 0 or max(i0, i1, i2) >= nverts:
                    continue
                self.add_triangle(get_v(i0), get_v(i1), get_v(i2),
                                  material_id, get_uv(i0), get_uv(i1),
                                  get_uv(i2))
        else:
            for i in range(0, len(positions) - 8, 9):
                self.add_triangle(positions[i:i + 3], positions[i + 3:i + 6],
                                  positions[i + 6:i + 9], material_id)
        return self

    def to_unified(self) -> dict:
        """JSON-friendly unified schema v2 (scene_api.js:195-236), extended
        with planes and point / directional lights; key for key the JAX
        package's dict."""
        mat_table = {str(mid): dataclasses.asdict(m)
                     for mid, m in self._materials.items()}
        for m in mat_table.values():
            m["albedo"] = list(m["albedo"])
            m["emission"] = list(m["emission"])
        return {
            "version": 2,
            "camera": dict(self._camera, pos=list(self._camera["pos"])),
            "atlas": {"width": self._atlas_size[0],
                      "height": self._atlas_size[1]},
            "materials": {"table": mat_table},
            "geometry": {
                "spheres": [dict(s) for s in self._spheres],
                "tris": [dict(t) for t in self._tris],
                "quads": [dict(q) for q in self._quads],
                "planes": [dict(p) for p in self._planes],
            },
            "lights": {
                "env": dict(self._env),
                "area": dict(self._area),
                "points": [dict(p) for p in self._point_lights],
                "directionals": [dict(d) for d in self._dir_lights],
            },
        }

    to_path_tracer = to_unified
    to_object = to_unified

    def reset(self) -> "SceneBuilder":
        """Clear geometry, lights, atlas and camera; keep the materials
        (scene_api.js:248-257)."""
        self._spheres, self._tris, self._quads, self._planes = [], [], [], []
        self._point_lights, self._dir_lights = [], []
        self._atlas_size, self._atlas_pixels = (0, 0), None
        self._env = {"color": [0.0, 0.0, 0.0], "intensity": 0.0}
        self._area = {"center": [3.0, 2.8, 3.0], "radius": 0.5, "auto": True}
        self._camera = {"pos": [2.78, 2.73, -8.00], "yaw": 0.0, "pitch": 0.0,
                        "fovY": 80 * math.pi / 180}
        return self

    def build(self, *, min_pad: int = 8, device="cuda") -> SceneData:
        """Pack into the padded struct-of-arrays scene on ``device``, every
        field as the JAX ``build()`` fills it. Capacities round up to a
        multiple of ``min_pad``. The camera stays on the host."""
        f32, i32 = np.float32, np.int32

        def rows(items, key, w=3):
            return np.asarray([it[key] for it in items],
                              dtype=f32).reshape(-1, w)

        S = _round_up(len(self._spheres), min_pad)
        sp = np.zeros((S, 3), f32)
        sr = np.zeros((S,), f32)
        sm = np.zeros((S,), i32)
        if self._spheres:
            n = len(self._spheres)
            sp[:n] = rows(self._spheres, "p")
            sr[:n] = [s["r"] for s in self._spheres]
            sm[:n] = [s["matId"] for s in self._spheres]

        T = _round_up(len(self._tris), min_pad)
        ta, tb, tc = (np.zeros((T, 3), f32) for _ in range(3))
        tm = np.zeros((T,), i32)
        tuva, tuvb, tuvc = (np.zeros((T, 2), f32) for _ in range(3))
        if self._tris:
            n = len(self._tris)
            ta[:n], tb[:n], tc[:n] = (rows(self._tris, k) for k in "abc")
            tm[:n] = [t["matId"] for t in self._tris]
            tuva[:n] = rows(self._tris, "uvA", 2)
            tuvb[:n] = rows(self._tris, "uvB", 2)
            tuvc[:n] = rows(self._tris, "uvC", 2)

        Q = _round_up(len(self._quads), min_pad)
        qa, qb, qc, qd = (np.zeros((Q, 3), f32) for _ in range(4))
        qm = np.zeros((Q,), i32)
        quv = [np.zeros((Q, 2), f32) for _ in range(4)]
        if self._quads:
            n = len(self._quads)
            qa[:n], qb[:n], qc[:n], qd[:n] = (rows(self._quads, k)
                                              for k in "abcd")
            qm[:n] = [q["matId"] for q in self._quads]
            for i, k in enumerate(["uv0", "uv1", "uv2", "uv3"]):
                quv[i][:n] = rows(self._quads, k, 2)

        P = _round_up(len(self._planes), min_pad)
        pn = np.zeros((P, 3), f32)
        pd = np.zeros((P,), f32)
        pm = np.zeros((P,), i32)
        if self._planes:
            n = len(self._planes)
            pn[:n] = rows(self._planes, "n")
            pd[:n] = [p["d"] for p in self._planes]
            pm[:n] = [p["matId"] for p in self._planes]

        max_id = max(self._materials) if self._materials else 0
        M = _round_up(max_id + 1, 8)
        alb = np.full((M, 3), 0.8, f32)  # GLSL LUT default vec3(0.8)
        emi = np.zeros((M,), bool)
        ems = np.zeros((M, 3), f32)
        rfl = np.zeros((M,), bool)
        rgh = np.zeros((M,), f32)
        for mid, m in self._materials.items():
            alb[mid] = m.albedo
            emi[mid] = m.emissive
            ems[mid] = m.emission
            rfl[mid] = m.reflective
            rgh[mid] = m.roughness

        # 0 point lights -> 0 capacity (not 8): the raster path drops the
        # three world-pos attribute planes when the capacity is 0 (the
        # lightless A = 6 specialisation of render_soup_diag), so padding a
        # lightless scene would re-enable all of that dead work.
        PL = 0 if not self._point_lights else _round_up(len(self._point_lights), 8)
        plp = np.zeros((PL, 3), f32)
        plc = np.zeros((PL, 3), f32)
        for i, L in enumerate(self._point_lights):
            plp[i] = L["p"]
            plc[i] = np.asarray(L["color"], f32) * f32(L["intensity"])
        DL = _round_up(len(self._dir_lights), 8)
        dld = np.zeros((DL, 3), f32)
        dlc = np.zeros((DL, 3), f32)
        for i, L in enumerate(self._dir_lights):
            dld[i] = L["dir"]
            dlc[i] = np.asarray(L["color"], f32) * f32(L["intensity"])

        if self._atlas_pixels is not None:
            at_rgb = self._atlas_pixels[..., :3]
            at_a = self._atlas_pixels[..., 3]
        else:
            at_rgb = np.zeros((1, 1, 3), np.uint8)
            at_a = np.zeros((1, 1), np.uint8)

        cam = Camera.create(pos=self._camera["pos"], yaw=self._camera["yaw"],
                            pitch=self._camera["pitch"],
                            fov_y_deg=self._camera["fovY"] * 180.0 / math.pi)

        def j(x):
            return torch.as_tensor(np.asarray(x), device=device)

        return SceneData(
            sph_pos=j(sp), sph_rad=j(sr), sph_mat=j(sm),
            n_sph=j(i32(len(self._spheres))),
            tri_a=j(ta), tri_b=j(tb), tri_c=j(tc), tri_mat=j(tm),
            tri_uva=j(tuva), tri_uvb=j(tuvb), tri_uvc=j(tuvc),
            n_tri=j(i32(len(self._tris))),
            quad_a=j(qa), quad_b=j(qb), quad_c=j(qc), quad_d=j(qd),
            quad_mat=j(qm), quad_uv0=j(quv[0]), quad_uv1=j(quv[1]),
            quad_uv2=j(quv[2]), quad_uv3=j(quv[3]),
            n_quad=j(i32(len(self._quads))),
            pln_n=j(pn), pln_d=j(pd), pln_mat=j(pm),
            n_pln=j(i32(len(self._planes))),
            mat_albedo=j(alb), mat_emissive=j(emi), mat_emission=j(ems),
            mat_reflective=j(rfl), mat_roughness=j(rgh),
            env_color=j(np.asarray(self._env["color"], f32)),
            env_intensity=j(f32(self._env["intensity"])),
            area_center=j(np.asarray(self._area["center"], f32)),
            area_radius=j(f32(self._area["radius"])),
            area_auto=j(np.bool_(self._area["auto"])),
            pt_pos=j(plp), pt_col=j(plc),
            n_pt=j(i32(len(self._point_lights))),
            dl_dir=j(dld), dl_col=j(dlc), n_dl=j(i32(len(self._dir_lights))),
            camera=cam,
            atlas_rgb=j(at_rgb), atlas_a=j(at_a),
        )


def create_scene_builder(max_spheres=64, max_tris=4096,
                         max_quads=4096) -> SceneBuilder:
    return SceneBuilder(max_spheres, max_tris, max_quads)


def from_legacy_object(obj: dict) -> SceneBuilder:
    """Adapt the legacy flat PT scene shape — {spheres: [{p, r, m}],
    planes: [{p: [nx,ny,nz,d], m}], tris: [{a,b,c,m}], envLight, dirLight}
    — the way the reference's raytrace backend does (raytrace.js:140-193),
    including its legacy material palette and the GLASS -> mirror
    promotion."""
    pal = {0: (5, 5, 5), 1: (0.9, 0.9, 0.9), 2: (0.7, 0.9, 0.7),
           3: (0.95, 0.45, 0.45), 6: (0.9, 0.95, 1.0)}
    sb = SceneBuilder()
    if not isinstance(obj, dict):
        return sb
    next_id = [100]  # private id space, one material per primitive

    def mat_for(m):
        m = int(m or 1)
        albedo = pal.get(m, (0.8, 0.8, 0.8))
        reflective = m > 4  # GLASS in PT -> mirror here (raytrace.js:164)
        mid = next_id[0]
        next_id[0] += 1
        sb.add_material(mid, Material(albedo=albedo, reflective=reflective))
        return mid

    if obj.get("camera"):
        cam = obj["camera"]
        sb.set_camera_pose(cam.get("pos", [2.78, 2.73, -8.0]),
                           yaw=float(cam.get("yaw", 0.0)),
                           pitch=float(cam.get("pitch", 0.0)))
    for s in obj.get("spheres", []):
        sb.add_sphere(s.get("p", [0, 0, 0]), float(s.get("r", 1.0)),
                      mat_for(s.get("m")))
    for p in obj.get("planes", []):
        v = p.get("p", [0, 1, 0, 0])
        sb.add_plane(v[:3], float(v[3]), mat_for(p.get("m")))
    for t in obj.get("tris", []):
        sb.add_triangle(t.get("a", [0, 0, 0]), t.get("b", [1, 0, 0]),
                        t.get("c", [0, 1, 0]), mat_for(t.get("m")))
    env = obj.get("envLight")
    if env:
        sb.set_env_light(env.get("color", [0, 0, 0]),
                         float(env.get("intensity", 0.0)))
    dl = obj.get("dirLight")
    if dl:
        sb.add_dir_light(dl.get("dir", [0, -1, 0]), dl.get("color", [1, 1, 1]),
                         float(dl.get("intensity", 0.0)))
    return sb


def from_object(obj: dict) -> SceneBuilder:
    """Rebuild a SceneBuilder from the unified schema
    (scene_api.js:266-319)."""
    sb = SceneBuilder()
    if not isinstance(obj, dict):
        return sb
    cam = obj.get("camera") or {}
    if cam:
        fovy = cam.get("fovY", 80 * math.pi / 180)
        sb.set_camera_pose(cam.get("pos", [2.78, 2.73, -8.00]),
                           yaw=float(cam.get("yaw", 0.0)),
                           pitch=float(cam.get("pitch", 0.0)),
                           fovy_deg=float(fovy) * 180.0 / math.pi)
    at = obj.get("atlas") or {}
    if at:
        sb.set_texture_atlas_size(int(at.get("width", 0)),
                                  int(at.get("height", 0)))
    table = (obj.get("materials") or {}).get("table") or {}
    for k, v in table.items():
        sb.add_material(_u32(k), v)
    lights = obj.get("lights") or {}
    if "env" in lights:
        sb.set_env_light(lights["env"].get("color", [0, 0, 0]),
                         lights["env"].get("intensity", 0.0))
    if "area" in lights:
        a = lights["area"]
        sb.set_area_light(a.get("center", [3, 2.8, 3]),
                          float(a.get("radius") or 0.5),
                          auto=bool(a.get("auto")))
    for L in lights.get("points", []):
        sb.add_point_light(L.get("p", [0, 0, 0]), L.get("color", [1, 1, 1]),
                           L.get("intensity", 0.0))
    for L in lights.get("directionals", []):
        sb.add_dir_light(L.get("dir", [0, -1, 0]), L.get("color", [1, 1, 1]),
                         L.get("intensity", 0.0))
    geo = obj.get("geometry") or {}
    for s in geo.get("spheres", []):
        sb.add_sphere(s.get("p", [0, 0, 0]), float(s.get("r") or 1.0),
                      _u32(s.get("matId", DEFAULT_MAT_ID)))
    for t in geo.get("tris", []):
        sb.add_triangle(t.get("a", [0, 0, 0]), t.get("b", [1, 0, 0]),
                        t.get("c", [0, 1, 0]),
                        _u32(t.get("matId", DEFAULT_MAT_ID)),
                        t.get("uvA", (0, 0)), t.get("uvB", (0, 0)),
                        t.get("uvC", (0, 0)))
    for q in geo.get("quads", []):
        sb.add_quad(q.get("a", [0, 0, 0]), q.get("b", [1, 0, 0]),
                    q.get("c", [1, 1, 0]), q.get("d", [0, 1, 0]),
                    _u32(q.get("matId", DEFAULT_MAT_ID)),
                    q.get("uv0", (0, 0)), q.get("uv1", (0, 0)),
                    q.get("uv2", (0, 0)), q.get("uv3", (0, 0)))
    for p in geo.get("planes", []):
        sb.add_plane(p.get("n", [0, 1, 0]), float(p.get("d") or 0.0),
                     _u32(p.get("matId", DEFAULT_MAT_ID)))
    return sb
