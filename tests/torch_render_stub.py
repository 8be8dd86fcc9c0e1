"""What the rendering tests of both stacks share: a stand-in for
``mujoco.Renderer`` (MuJoCo cannot open a GL context on a host without a
display) and a reader of the written videos."""

import contextlib
import io

import numpy as np


class StubRenderer:
    """``mujoco.Renderer``'s interface without a GL context: each body's
    position after ``mj_forward`` (x, z) as a square on a plain image."""

    def __init__(self, model, height=240, width=320):
        self.h, self.w = height, width

    def update_scene(self, data):
        self.xpos = np.array(data.xpos)

    def render(self):
        img = np.full((self.h, self.w, 3), 40, np.uint8)
        for b, (x, _, z) in enumerate(self.xpos):
            u = int(self.w / 2 + x * self.w / 4)
            v = int(self.h - z * self.h / 2.5)
            u, v = min(max(u, 2), self.w - 3), min(max(v, 2), self.h - 3)
            img[v - 2:v + 3, u - 2:u + 3] = (255 - 12 * b, 60 + 10 * b, 128)
        return img

    def close(self):
        pass


def read_frames(path: str) -> list:
    """Every frame of a video file, decoded by cv2."""
    import cv2

    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


def stdout_of(fn, *args, **kw):
    """(what ``fn(*args, **kw)`` printed, what it returned)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return buf.getvalue(), out
