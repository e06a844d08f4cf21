"""Demo scenes — golden-test fixtures (ref: js/scene.js); a copy of
``ascii_renderer_tpu/scene/demo.py`` on the port's SceneBuilder.

``create_demo_scene`` reproduces the reference demo exactly: a 16-unit white
box room, a textured poster quad (26x24 texels of the ASCII atlas), one glass
and one red sphere, four "colored" emissive ceiling quads.

Quirk preserved deliberately: the reference adds those four lights with
``MaterialIds.LIGHT_RED/BLUE/GREEN/YELLOW`` which are *undefined* in its
MaterialIds table (js/scene.js:66-69); ``undefined`` coerces through _u32 to
0 = LIGHT, so all four quads get the plain LIGHT material. We keep that
behavior (material 0) and note it here for the record.
"""

from __future__ import annotations

from ascii_renderer_tpu_torch.scene.builder import MaterialIds, SceneBuilder


def create_demo_scene() -> SceneBuilder:
    sb = SceneBuilder()

    cam_pos = [0.0, 1.5, 6.0]
    sb.set_camera_pose(cam_pos, yaw=0.0, pitch=0.0)

    # Large white cube room: 6 quads (js/scene.js:11-26).
    L, H = 8.0, 16.0
    sb.add_quad([-L, 0, -L], [L, 0, -L], [L, 0, L], [-L, 0, L], MaterialIds.WHITE)   # floor
    sb.add_quad([-L, H, -L], [L, H, -L], [L, H, L], [-L, H, L], MaterialIds.WHITE)   # ceiling
    sb.add_quad([-L, 0, -L], [L, 0, -L], [L, H, -L], [-L, H, -L], MaterialIds.WHITE)  # back
    sb.add_quad([-L, 0, L], [L, 0, L], [L, H, L], [-L, H, L], MaterialIds.WHITE)      # front
    sb.add_quad([-L, 0, -L], [-L, 0, L], [-L, H, L], [-L, H, -L], MaterialIds.WHITE)  # left
    sb.add_quad([L, 0, -L], [L, 0, L], [L, H, L], [L, H, -L], MaterialIds.WHITE)      # right

    # Poster quad with atlas UVs (js/scene.js:28-48).
    tex_w, tex_h = 26, 24
    poster_scale = 0.12
    pw = tex_w * poster_scale
    ph = tex_h * poster_scale * 2
    pz = cam_pos[2] - 3.0
    px, py = cam_pos[0], cam_pos[1] + 1
    a = [px - pw * 0.5, py - ph * 0.5, pz]
    b = [px + pw * 0.5, py - ph * 0.5, pz]
    c = [px + pw * 0.5, py + ph * 0.5, pz]
    d = [px - pw * 0.5, py + ph * 0.5, pz]
    sb.add_quad(a, b, c, d, MaterialIds.WHITE, (0, 24), (26, 24), (26, 0), (0, 0))

    # Spheres (js/scene.js:50-52).
    sb.add_sphere([-3.0, 1.2, cam_pos[2] - 2.0], 1.0, MaterialIds.GLASS)
    sb.add_sphere([3.0, 1.2, cam_pos[2] - 2.5], 1.0, MaterialIds.RED)

    # Four ceiling light quads; material id resolves to 0 = LIGHT (see
    # module docstring for the reproduced reference quirk).
    light_size, cy = 3.0, 6.0

    def add_light(cx, cz):
        sb.add_quad([cx - light_size, cy, cz - light_size],
                    [cx + light_size, cy, cz - light_size],
                    [cx + light_size, cy, cz + light_size],
                    [cx - light_size, cy, cz + light_size],
                    MaterialIds.LIGHT)

    add_light(-4.0, cam_pos[2])
    add_light(4.0, cam_pos[2])
    add_light(0.0, cam_pos[2] - 5.0)
    add_light(0.0, cam_pos[2] + 5.0)

    return sb


def create_rt_demo_scene() -> SceneBuilder:
    """A deterministic-tracer fixture with the lights the raytrace backend
    consumes (point + directional + env; the reference reaches these only
    through its legacy-scene adapter, raytrace.js:146-192)."""
    sb = SceneBuilder()
    sb.set_camera_pose([0.0, 1.5, 6.0], yaw=-1.5707963, pitch=0.0)  # look -z
    sb.add_plane([0, 1, 0], 0.0, MaterialIds.WHITE)  # floor y=0
    sb.add_sphere([-1.6, 1.0, 0.0], 1.0, MaterialIds.RED)
    sb.add_sphere([1.6, 1.0, 0.0], 1.0, MaterialIds.MIRROR)
    sb.add_sphere([0.0, 0.75, 2.0], 0.75, MaterialIds.GREEN)
    sb.set_env_light([0.55, 0.7, 0.95], 1.0)
    # dir-light vectors are the direction light TRAVELS (both reference
    # shaders negate the uniform: raytrace_shader.js:173, raster_shader.js:47)
    sb.add_dir_light([0.25, -0.6, -0.75], [1.0, 0.97, 0.9], 0.9)
    sb.add_point_light([0.0, 3.0, 5.0], [1.0, 0.9, 0.8], 3.0)
    return sb
