"""Scene authoring API + packed device scene (torch port of the parts of
``ascii_renderer_tpu/scene/builder.py`` the raster main path calls).

``SceneData`` keeps every field of the JAX pytree, as tensors, so
``tessellate_scene``, the raster shading and ``utils.from_jax`` see one
schema. The builder covers lights, camera pose and the material table;
spheres, quads, the atlas and the JSON schema are ROADMAP A2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

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


def _u32(x) -> int:
    try:
        n = math.floor(float(x))
    except (TypeError, ValueError):
        return 0
    if not math.isfinite(n) or n < 0:
        return 0
    return int(n) & 0xFFFFFFFF


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


class SceneBuilder:
    """Fluent scene authoring (scene_api.js:52-258), raster-path subset."""

    def __init__(self):
        self._materials: Dict[int, Material] = {}
        self._point_lights: List[dict] = []
        self._dir_lights: List[dict] = []
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

    def add_material(self, mat_id, mat: Material) -> int:
        mid = _u32(mat_id)
        self._materials[mid] = mat.clamped()
        return mid

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

    def add_point_light(self, pos, color=(1, 1, 1), intensity=1.0) -> "SceneBuilder":
        self._point_lights.append({"p": _v3(pos), "color": _v3(color),
                                   "intensity": float(intensity)})
        return self

    def add_dir_light(self, direction, color=(1, 1, 1), intensity=1.0) -> "SceneBuilder":
        self._dir_lights.append({"dir": _v3(direction), "color": _v3(color),
                                 "intensity": float(intensity)})
        return self

    def build(self, *, min_pad: int = 8, device="cpu") -> SceneData:
        """Pack into the padded struct-of-arrays scene on ``device``. Geometry
        capacities are ``min_pad`` empty slots (this builder adds none)."""
        f32, i32 = np.float32, np.int32
        S = T = Q = P = _round_up(0, min_pad)

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

        cam = Camera.create(pos=self._camera["pos"], yaw=self._camera["yaw"],
                            pitch=self._camera["pitch"],
                            fov_y_deg=self._camera["fovY"] * 180.0 / math.pi)

        def j(x):
            return torch.as_tensor(np.asarray(x), device=device)

        z3 = lambda n: np.zeros((n, 3), f32)  # noqa: E731
        z2 = lambda n: np.zeros((n, 2), f32)  # noqa: E731
        zi = lambda n: np.zeros((n,), i32)  # noqa: E731
        return SceneData(
            sph_pos=j(z3(S)), sph_rad=j(np.zeros((S,), f32)), sph_mat=j(zi(S)),
            n_sph=j(i32(0)),
            tri_a=j(z3(T)), tri_b=j(z3(T)), tri_c=j(z3(T)), tri_mat=j(zi(T)),
            tri_uva=j(z2(T)), tri_uvb=j(z2(T)), tri_uvc=j(z2(T)),
            n_tri=j(i32(0)),
            quad_a=j(z3(Q)), quad_b=j(z3(Q)), quad_c=j(z3(Q)), quad_d=j(z3(Q)),
            quad_mat=j(zi(Q)), quad_uv0=j(z2(Q)), quad_uv1=j(z2(Q)),
            quad_uv2=j(z2(Q)), quad_uv3=j(z2(Q)), n_quad=j(i32(0)),
            pln_n=j(z3(P)), pln_d=j(np.zeros((P,), f32)), pln_mat=j(zi(P)),
            n_pln=j(i32(0)),
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
            atlas_rgb=j(np.zeros((1, 1, 3), np.uint8)),
            atlas_a=j(np.zeros((1, 1), np.uint8)),
        )
