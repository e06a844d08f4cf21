"""Camera state and controls (torch port of
``ascii_renderer_tpu/core/camera.py``; ref: js/camera.js).

Camera convention (identical across all backends):
  look = (cos p * cos y,  sin p,  cos p * sin y)      up = (0,1,0)
  focal = 1 / tan(fovY/2),  fovY default 80 deg

The camera is a handful of scalars; it lives on the host (``device``
defaults to the CPU) so the MVP it yields is the same float32 matrix
whichever device renders the frame.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_PITCH_LIMIT = math.pi * 0.5 - 0.1  # just shy of +/-90 deg (js/camera.js:34)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Camera:
    pos: torch.Tensor  # f32 [3]
    yaw: torch.Tensor  # f32 scalar
    pitch: torch.Tensor  # f32 scalar
    fov_y: torch.Tensor  # f32 scalar (radians)
    speed: torch.Tensor  # f32 scalar, units/sec (js/camera.js:11)
    sensitivity: torch.Tensor  # f32 scalar, rad/sec (js/camera.js:12)

    @staticmethod
    def create(pos=(0.0, 0.0, 5.0), yaw=0.0, pitch=0.0, fov_y_deg=80.0,
               speed=2.5, sensitivity=1.5, device="cpu") -> "Camera":
        return Camera(
            pos=_f32([float(v) for v in pos], device),
            yaw=_f32(float(yaw), device),
            pitch=_f32(float(pitch), device),
            fov_y=_f32(fov_y_deg * math.pi / 180.0, device),
            speed=_f32(float(speed), device),
            sensitivity=_f32(float(sensitivity), device),
        )

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class CameraInputs:
    """Per-frame input snapshot (keysPressed plus pointer-look deltas)."""

    forward: torch.Tensor  # W
    back: torch.Tensor  # S
    left: torch.Tensor  # A
    right: torch.Tensor  # D
    up: torch.Tensor  # Space
    down: torch.Tensor  # Shift
    look_up: torch.Tensor  # ArrowUp
    look_down: torch.Tensor  # ArrowDown
    look_left: torch.Tensor  # ArrowLeft
    look_right: torch.Tensor  # ArrowRight
    mouse_dx: torch.Tensor  # pointer-look delta (pixels this frame)
    mouse_dy: torch.Tensor

    @staticmethod
    def from_keys(keys=(), mouse_dx=0.0, mouse_dy=0.0,
                  device="cpu") -> "CameraInputs":
        keys = {str(k).lower() for k in keys}

        def b(k):
            return _f32(1.0 if k in keys else 0.0, device)

        return CameraInputs(
            forward=b("w"), back=b("s"), left=b("a"), right=b("d"),
            up=b(" "), down=b("shift"),
            look_up=b("arrowup"), look_down=b("arrowdown"),
            look_left=b("arrowleft"), look_right=b("arrowright"),
            mouse_dx=_f32(float(mouse_dx), device),
            mouse_dy=_f32(float(mouse_dy), device),
        )


def update_camera(cam: Camera, inputs: CameraInputs, dt) -> Camera:
    """Pure integrator, semantics of js/camera.js:23-53 plus the pointer-look
    path of js/main.js:108-118 (same op order as the JAX twin)."""
    dt = _f32(float(dt), cam.yaw.device)
    look_step = cam.sensitivity * dt
    mouse_sens = cam.sensitivity * 0.002

    pitch = cam.pitch + look_step * (inputs.look_up - inputs.look_down)
    yaw = cam.yaw + look_step * (inputs.look_right - inputs.look_left)
    yaw = yaw + inputs.mouse_dx * mouse_sens
    pitch = pitch - inputs.mouse_dy * mouse_sens

    pitch = torch.clamp(pitch, -_PITCH_LIMIT, _PITCH_LIMIT)
    pi = _f32(math.pi, yaw.device)
    yaw = torch.where(yaw > pi, yaw - 2 * pi, yaw)
    yaw = torch.where(yaw < -pi, yaw + 2 * pi, yaw)

    move = cam.speed * dt
    zero = torch.zeros_like(yaw)
    fwd = torch.stack([torch.cos(yaw), zero, torch.sin(yaw)])
    right = torch.stack([torch.sin(yaw), zero, -torch.cos(yaw)])
    pos = cam.pos
    pos = pos + fwd * (move * (inputs.forward - inputs.back))
    pos = pos + right * (move * (inputs.left - inputs.right))
    pos = pos + torch.stack([zero, move * (inputs.up - inputs.down), zero])

    return cam.replace(pos=pos, yaw=yaw, pitch=pitch)
