"""smallpt-style camera: ray generation with tent-filter jitter.

Port of ``raytracer_tpu/models/camera.py``. ``cx = (0.5135*w/h, 0, 0)``,
``cy = norm(cx x dir) * 0.5135``; each pixel is a 2x2 subpixel grid jittered
by the tent filter. The scene's camera dir is used unnormalized in the sum
and the ray direction is normalized. ``py`` is the render-space row
(0 = bottom); callers flip when they assemble images.

``camera_rays3`` builds the image-plane basis and the image size as device
scalars at each call, which copies host numbers to the device; a caller
that makes rays many times (the regen engine, once a loop step, and inside
a CUDA graph, where no such copy may run) builds them once with
``camera_frame`` and passes them in.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.models.scene import SceneArrays


def tent_jitter(u: torch.Tensor) -> torch.Tensor:
    """Tent filter over [-1,1] from uniform [0,1) (src/server.rs:339-351)."""
    r = 2.0 * u
    return torch.where(
        r < 1.0, torch.sqrt(r) - 1.0, 1.0 - torch.sqrt(torch.clamp_min(2.0 - r, 0.0))
    )


def camera_basis(scene: SceneArrays, width: int, height: int, fov_scale: float):
    """(cx, cy) image-plane basis vectors, f32 [3] each, on the scene's device."""
    dev = scene.device
    w = torch.tensor(float(width), dtype=torch.float32, device=dev)
    h = torch.tensor(float(height), dtype=torch.float32, device=dev)
    fov = torch.tensor(fov_scale, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    cx = torch.stack([fov, zero, zero]) * (w / h)
    d = scene.cam_dir
    c = torch.stack([
        cx[1] * d[2] - cx[2] * d[1],
        cx[2] * d[0] - cx[0] * d[2],
        cx[0] * d[1] - cx[1] * d[0],
    ])
    n2 = c[0] * c[0] + c[1] * c[1] + c[2] * c[2]
    cy = c / torch.sqrt(n2) * fov
    return cx, cy


def camera_frame(scene: SceneArrays, width: int, height: int, fov_scale: float):
    """(cx, cy, w, h): ``camera_basis`` and the image size as f32 scalars,
    on the scene's device; ``camera_rays3``'s optional ``frame``."""
    dev = scene.device
    w = torch.tensor(float(width), dtype=torch.float32, device=dev)
    h = torch.tensor(float(height), dtype=torch.float32, device=dev)
    return (*camera_basis(scene, width, height, fov_scale), w, h)


def camera_rays3(
    scene: SceneArrays,
    width: int,
    height: int,
    fov_scale: float,
    px: torch.Tensor,  # [N] pixel column
    py: torch.Tensor,  # [N] pixel row in RENDER space (0 = bottom)
    sx: torch.Tensor,  # [N] subpixel column in {0,1}
    sy: torch.Tensor,  # [N] subpixel row in {0,1}
    u1: torch.Tensor,  # [N] uniform for dx
    u2: torch.Tensor,  # [N] uniform for dy
    frame: tuple | None = None,  # camera_frame(scene, width, height, fov_scale)
):
    """N camera rays in component form -> (ro=(x,y,z), rd=(x,y,z)); without
    ``frame`` the basis and the size are built here."""
    if frame is None:
        dev = px.device
        w = torch.tensor(float(width), dtype=torch.float32, device=dev)
        h = torch.tensor(float(height), dtype=torch.float32, device=dev)
        cx, cy = camera_basis(scene, width, height, fov_scale)
    else:
        cx, cy, w, h = frame
    dx = tent_jitter(u1)
    dy = tent_jitter(u2)
    fx = ((sx + 0.5 + dx) / 2.0 + px) / w - 0.5
    fy = ((sy + 0.5 + dy) / 2.0 + py) / h - 0.5
    d = [cx[k] * fx + cy[k] * fy + scene.cam_dir[k] for k in range(3)]
    inv = 1.0 / torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    rd = tuple(d[k] * inv for k in range(3))
    ro = tuple(scene.cam_pos[k].expand(rd[0].shape) for k in range(3))
    return ro, rd
