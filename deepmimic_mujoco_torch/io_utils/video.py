"""Video export (port of ``deepmimic_mujoco_tpu/io_utils/video.py``, the
reference's ``VideoSaver.py``): an OpenCV MJPG writer, and a qpos
trajectory rendered through host MuJoCo from the humanoid's MJCF
(``physics/humanoid.to_mjcf(visual=True)``).

Rendering runs on the host only: cv2 and MuJoCo are imported inside the
functions that use them, so the rest of the port imports where they are
absent (the card's machine has neither).  :func:`require_renderer` lets an
entry point fail on a missing one before it does any other work."""

from __future__ import annotations

from typing import Optional

import numpy as np


def require_renderer() -> None:
    """Raises ``ImportError`` naming MuJoCo or cv2 when either cannot be
    imported: both are needed to render a video."""
    try:
        import mujoco  # noqa: F401
        import cv2  # noqa: F401
    except ImportError as e:
        raise ImportError(f"{e.name} is needed to render video and cannot "
                          f"be imported here ({e})", name=e.name) from e


class VideoSaver:
    """MJPG ``.avi`` writer of RGB frames (resized to width × height)."""

    def __init__(self, width: int = 640, height: int = 480, fps: int = 60,
                 output_path: str = "video.avi"):
        import cv2

        self.width = width
        self.height = height
        self.writer = cv2.VideoWriter(
            output_path, cv2.VideoWriter_fourcc(*"MJPG"), fps,
            (width, height))

    def add_frame(self, frame: np.ndarray) -> None:
        import cv2

        if frame.shape[1::-1] != (self.width, self.height):
            frame = cv2.resize(frame, (self.width, self.height))
        self.writer.write(frame[..., ::-1])  # RGB → BGR

    def close(self) -> None:
        self.writer.release()


def render_qpos_trajectory(qpos_traj: np.ndarray, out_path: str,
                           fps: Optional[int] = None, width: int = 640,
                           height: int = 480) -> str:
    """Render a (T, nq) qpos trajectory to ``out_path`` through host
    MuJoCo's renderer, one frame per row (``fps`` default: one frame per
    model timestep).  Returns ``out_path``."""
    import mujoco

    from deepmimic_mujoco_torch.physics.humanoid import to_mjcf

    m = mujoco.MjModel.from_xml_string(to_mjcf(visual=True))
    d = mujoco.MjData(m)
    renderer = mujoco.Renderer(m, height=height, width=width)
    saver = VideoSaver(width=width, height=height,
                       fps=fps or int(round(1.0 / m.opt.timestep)),
                       output_path=out_path)
    try:
        for qpos in np.asarray(qpos_traj):
            d.qpos[:] = qpos
            mujoco.mj_forward(m, d)
            renderer.update_scene(d)
            saver.add_frame(renderer.render())
    finally:
        saver.close()
        renderer.close()
    return out_path
