"""Frame presentation: frames written to disk, and a live HTTP preview.

As `nebulae_tpu/utils/display.py`: `FrameWriter` "presents" each frame by
encoding it to frame_%05d.png (or .npy) on a thread of its own, with two
frames in flight (a present waits only for the previous frame's encode);
`PreviewServer` serves the latest frame at http://127.0.0.1:<port>/.  Both
encode PNG with `utils/png.py`.  `ldr_to_srgb_u8` maps display-linear
[0, 1] to sRGB bytes: on the tensor's own device for a CUDA tensor, in
numpy (JAX's arithmetic) otherwise.
"""

from __future__ import annotations

import threading
from pathlib import Path

import numpy as np
import torch

from nebulae_tpu_torch.utils import png


def _linear_to_srgb_np(c: np.ndarray) -> np.ndarray:
    c = np.clip(c, 0.0, 1.0)
    lo = c * 12.92
    hi = 1.055 * np.maximum(c, 1e-8) ** (1.0 / 2.4) - 0.055
    return np.where(c <= 0.0031308, lo, hi)


def ldr_to_srgb_u8(ldr) -> np.ndarray:
    """Display-linear [0, 1] [H, W, 3] -> sRGB-encoded uint8 on the host."""
    if isinstance(ldr, torch.Tensor) and ldr.device.type != "cpu":
        from nebulae_tpu_torch.core.texture import linear_to_srgb

        img = linear_to_srgb(torch.clamp(ldr.detach(), 0.0, 1.0))
        return (img * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
    if isinstance(ldr, torch.Tensor):
        ldr = ldr.detach().numpy()
    img = _linear_to_srgb_np(np.clip(np.asarray(ldr), 0.0, 1.0))
    return (img * 255.0 + 0.5).astype(np.uint8)


def colorize_map(values, vmin: float | None = None, vmax: float | None = None) -> np.ndarray:
    """Scalar [H, W] debug buffer -> heat-map RGB u8 (dark blue -> red ->
    yellow); negative sentinels (-1 = "never") render black."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    v = np.asarray(values, np.float32)
    neg = v < 0.0
    if vmin is None:
        vmin = float(v[~neg].min()) if (~neg).any() else 0.0
    if vmax is None:
        vmax = float(v.max())
    t = np.clip((v - vmin) / max(vmax - vmin, 1e-6), 0.0, 1.0)
    lo = np.array([0.05, 0.03, 0.30], np.float32)
    mid = np.array([0.90, 0.20, 0.10], np.float32)
    hi = np.array([1.00, 0.95, 0.20], np.float32)
    a = np.clip(t * 2.0, 0.0, 1.0)[..., None]
    b = np.clip(t * 2.0 - 1.0, 0.0, 1.0)[..., None]
    rgb = lo * (1 - a) + mid * a
    rgb = rgb * (1 - b) + hi * b
    rgb[neg] = 0.0
    return (rgb * 255.0 + 0.5).astype(np.uint8)


class FrameWriter:
    """Frames to `out_dir` as frame_%05d.png or .npy, encoded on a thread,
    two frames in flight."""

    def __init__(self, out_dir: str | Path, fmt: str = "png"):
        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fmt = fmt
        self.frame = 0
        self._pending: threading.Thread | None = None

    def present(self, ldr) -> Path:
        """Queue the frame for encode; blocks only on the previous encode."""
        data = ldr_to_srgb_u8(ldr)
        path = self.dir / f"frame_{self.frame:05d}.{self.fmt}"
        if self._pending is not None:
            self._pending.join()

        def write():
            if self.fmt == "png":
                png.write_png(path, data)
            else:
                np.save(path, data)

        self._pending = threading.Thread(target=write)
        self._pending.start()
        self.frame += 1
        return path

    def flush(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None


class PreviewServer:
    """The latest presented frame over localhost HTTP: an auto-refreshing
    page at / and the image at /frame.png.  The server runs on a daemon
    thread; `update` swaps the frame's bytes, and a request encodes the
    newest frame once (cached per frame), so the render loop pays nothing
    without a viewer."""

    def __init__(self, port: int = 8642, host: str = "127.0.0.1"):
        import http.server

        self._lock = threading.Lock()
        self._u8: np.ndarray | None = None
        self._png: bytes | None = None
        self._frame = 0
        self._encoded_frame = -1
        server_self = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, ctype: str, body: bytes, no_store: bool = False):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                if no_store:
                    self.send_header("Cache-Control", "no-store")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    data = server_self._encode_latest()
                    if data is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self._send("image/png", data, no_store=True)
                elif self.path == "/" or self.path.startswith("/index"):
                    self._send("text/html", (
                        "<!doctype html><title>nebulae preview</title>"
                        "<body style='margin:0;background:#111'>"
                        "<img id=f style='width:100vw;image-rendering:pixelated'>"
                        "<script>const i=document.getElementById('f');"
                        "setInterval(()=>{i.src='/frame.png?t='+Date.now();},250);"
                        "</script></body>"
                    ).encode())
                else:
                    self.send_response(404)
                    self.end_headers()

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def update(self, ldr_or_u8) -> None:
        """Swap in a new frame (display-linear [0, 1] float or sRGB u8)."""
        if isinstance(ldr_or_u8, np.ndarray) and ldr_or_u8.dtype == np.uint8:
            data = ldr_or_u8
        else:
            data = ldr_to_srgb_u8(ldr_or_u8)
        with self._lock:
            self._u8 = data
            self._frame += 1

    def _encode_latest(self) -> bytes | None:
        """The newest frame as PNG (handler thread; cached per frame)."""
        with self._lock:
            if self._u8 is None:
                return self._png
            if self._encoded_frame == self._frame and self._png is not None:
                return self._png
            data, frame = self._u8, self._frame
        encoded = png.encode_png(data)
        with self._lock:
            self._png = encoded
            self._encoded_frame = frame
        return encoded

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
