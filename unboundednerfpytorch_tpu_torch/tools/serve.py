"""Minimal render server: serve novel views of a trained (or baked)
checkpoint over HTTP, on the GPU.

The port's copy of the JAX package's ``tools/serve.py``. Train, optionally
``--program export_baked``, then point this server at the checkpoint
directory, or at a reference ``.tar`` (``utils/reference_import.py``). No
dataset is needed: cameras come from the request (orbit parameters around
the scene centre recovered from the model config). The model is loaded onto
the card once, and the family's render cache is built once at start-up;
where the family gives none (a TensoRF field, or tables over the memory
guard) the views render from the grids. A cache that fails to build raises.

    python -m unboundednerfpytorch_tpu_torch.tools.serve --ckpt logs/scene/fine_last --port 8000
    curl 'localhost:8000/render?theta=30&phi=-15&r=1.2&w=400&h=300' > v.png

Endpoints:
  GET /health            -> {"status": "ok", ...}
  GET /meta              -> scene center/radius, family, step
  GET /render?theta=&phi=&r=&w=&h=&focal=  -> image/png
      theta/phi: azimuth/elevation in degrees; r: camera distance as a
      multiple of the scene radius; focal: focal length as a multiple of W.

Single-threaded by design: renders are serialized by a lock.
"""
from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np


class RenderService:
    """Loads the checkpoint once; renders look-at views on demand.
    ``stepsize``: the march's step (default: the checkpoint's config's).
    ``device``: ``None`` -> ``cuda`` (raises without a GPU); ``"cpu"`` for
    the plain path."""

    def __init__(self, ckpt_path: str, near: float = 0.05, bg: float = 1.0,
                 stepsize: float | None = None, device=None):
        from unboundednerfpytorch_tpu_torch.convert import FAMILIES
        from unboundednerfpytorch_tpu_torch.device import resolve_device
        from unboundednerfpytorch_tpu_torch.train.loop import make_forward
        from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

        self.device = resolve_device(device)
        family, mcfg, params, step, _ = ckpt.load_model(ckpt_path, device=self.device,
                                                        with_opt_state=False)
        params.requires_grad_(False)
        self.family, self.mcfg, self.params, self.step = family, mcfg, params, int(step)

        if hasattr(mcfg, "scene_center"):
            self.center = np.asarray(mcfg.scene_center, np.float64)
            self.radius = float(np.max(np.asarray(mcfg.scene_radius)))
        else:
            mn = np.asarray(mcfg.xyz_min, np.float64)
            mx = np.asarray(mcfg.xyz_max, np.float64)
            self.center = (mn + mx) / 2
            self.radius = float(np.linalg.norm(mx - mn)) / 2

        self.render_kwargs = {
            "near": near,
            "far": 1e9,
            "bg": bg,
            "stepsize": stepsize or getattr(mcfg, "stepsize", 1.0),
        }
        self.cache = FAMILIES[family].build_render_cache(params, mcfg, log_fn=print)
        fwd_core = make_forward(mcfg, self.render_kwargs, cache=self.cache)
        self._fwd = lambda ro, rd, vd: fwd_core(params, ro, rd, vd, None)
        self._lock = threading.Lock()

    def render(self, theta=0.0, phi=-15.0, r=1.2, w=400, h=300, focal=1.2) -> bytes:
        """The view as PNG bytes."""
        from PIL import Image

        from unboundednerfpytorch_tpu_torch.data.synthetic import look_at_pose
        from unboundednerfpytorch_tpu_torch.render import renderer
        from unboundednerfpytorch_tpu_torch.utils import metrics as M

        th, ph = np.radians(theta), np.radians(phi)
        pos = self.center + r * self.radius * np.array([
            np.cos(ph) * np.cos(th), np.cos(ph) * np.sin(th), np.sin(ph)])
        pose = look_at_pose(pos, self.center)
        K = np.array([[focal * w, 0, w / 2], [0, focal * w, h / 2], [0, 0, 1]], np.float32)
        with self._lock:
            rgb = renderer.render_image(self._fwd, int(h), int(w), K, pose[:3, :4],
                                        device=self.device)[0]
        buf = io.BytesIO()
        Image.fromarray(M.to8b(rgb)).save(buf, format="PNG")
        return buf.getvalue()

    def meta(self) -> dict:
        return {
            "family": self.family,
            "step": self.step,
            "scene_center": self.center.tolist(),
            "scene_radius": self.radius,
        }


def make_handler(service: RenderService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/health":
                return self._json({"status": "ok", **service.meta()})
            if u.path == "/meta":
                return self._json(service.meta())
            if u.path == "/render":
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                try:
                    png = service.render(
                        theta=float(q.get("theta", 0)),
                        phi=float(q.get("phi", -15)),
                        r=float(q.get("r", 1.2)),
                        w=min(int(q.get("w", 400)), 4096),
                        h=min(int(q.get("h", 300)), 4096),
                        focal=float(q.get("focal", 1.2)),
                    )
                except (ValueError, TypeError) as e:
                    return self._json({"error": str(e)}, 400)
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(png)))
                self.end_headers()
                self.wfile.write(png)
                return
            self._json({"error": f"unknown path {u.path}"}, 404)

    return Handler


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint dir (fine_last / baked_last, the port's or the JAX "
                         "package's) or a reference .tar")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--near", type=float, default=0.05)
    ap.add_argument("--bg", type=float, default=1.0)
    args = ap.parse_args(argv)

    service = RenderService(args.ckpt, near=args.near, bg=args.bg)
    srv = HTTPServer((args.host, args.port), make_handler(service))
    print(f"serving {args.ckpt} ({service.family}, step {service.step}) "
          f"on http://{args.host}:{srv.server_address[1]}")
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
