"""Minimal dependency-free web viewer for trained models (counterpart of
``cropnerf_tpu/viewer/server.py``).

Headless-friendly equivalent of the reference's viser viewer (its
debug/viewer.py boots an eval-mode nerfstudio ViewerState at :7007).  A
single-page orbit viewer over plain ``http.server``: the browser requests
``/render?theta=..&phi=..&r=..&f=..&channel=..`` and receives a PNG
rendered by the port's chunked renderer on the card; arrow keys and drag
orbit the camera, a channel selector switches rgb / semantics / depth /
accumulation / instances (and uncertainty with a BayesRays grid).

``_PAGE``, :class:`ViewerServer` and ``_overlay_instances`` are
framework-free and kept as the JAX module has them; the overlay gets the
cameras on the host.  :func:`make_model_renderer` binds the port's
``make_render_fn`` (with the uncertainty filter as its density hook),
``orbit_cameras`` and ``render_uncertainty``.
"""
from __future__ import annotations

import dataclasses
import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

_PAGE = """<!DOCTYPE html>
<html><head><title>cropnerf viewer</title><style>
body{background:#111;color:#eee;font-family:sans-serif;margin:0;text-align:center}
img{image-rendering:pixelated;width:70vmin;height:70vmin;margin-top:1em}
select,button{margin:0.5em}
</style></head><body>
<div>
  <select id="channel"><option>rgb</option><option>semantics_colormap</option>
  <option>depth</option><option>accumulation</option>
  <option>instances</option></select>
  radius <input type="range" id="r" min="0.4" max="3" step="0.1" value="1.2">
  filter <input type="range" id="f" min="0" max="1" step="0.02" value="1">
  <span id="status"></span>
</div>
<img id="view" width="400" height="400">
<script>
let theta=0, phi=0.25, busy=false, dirty=true;
const img=document.getElementById('view');
function refresh(){
  if(busy){dirty=true;return;}
  busy=true;dirty=false;
  const r=document.getElementById('r').value;
  const f=document.getElementById('f').value;
  const ch=document.getElementById('channel').value;
  const t0=performance.now();
  fetch(`/render?theta=${theta}&phi=${phi}&r=${r}&f=${f}&channel=${ch}`)
   .then(resp=>resp.blob()).then(b=>{
     img.src=URL.createObjectURL(b);
     document.getElementById('status').textContent=
       `${(performance.now()-t0).toFixed(0)} ms`;
     busy=false; if(dirty) refresh();
   }).catch(()=>{busy=false;});
}
window.addEventListener('keydown',e=>{
  if(e.key==='ArrowLeft')theta-=0.2; else if(e.key==='ArrowRight')theta+=0.2;
  else if(e.key==='ArrowUp')phi=Math.min(1.3,phi+0.1);
  else if(e.key==='ArrowDown')phi=Math.max(-1.3,phi-0.1); else return;
  refresh();
});
let drag=null;
img.addEventListener('mousedown',e=>drag=[e.clientX,e.clientY]);
window.addEventListener('mouseup',()=>drag=null);
window.addEventListener('mousemove',e=>{
  if(!drag)return;
  theta+=(e.clientX-drag[0])*0.01; phi+=(e.clientY-drag[1])*0.01;
  phi=Math.max(-1.3,Math.min(1.3,phi)); drag=[e.clientX,e.clientY];
  refresh();
});
document.getElementById('channel').onchange=refresh;
document.getElementById('r').oninput=refresh;
document.getElementById('f').oninput=refresh;
refresh();
</script></body></html>"""


class ViewerServer:
    """Serve an interactive orbit view of a trained model.

    render_image(theta, phi, radius, channel) -> [H, W, 3] float image is
    supplied by the caller (see :func:`make_model_renderer`).
    """

    def __init__(self, render_image, host: str = "0.0.0.0", port: int = 7007):
        self.render_image = render_image
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                parsed = urlparse(self.path)
                if parsed.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if parsed.path == "/render":
                    q = parse_qs(parsed.query)
                    img = outer.render_image(
                        theta=float(q.get("theta", ["0"])[0]),
                        phi=float(q.get("phi", ["0.25"])[0]),
                        radius=float(q.get("r", ["1.2"])[0]),
                        channel=q.get("channel", ["rgb"])[0],
                        unc_filter=float(q.get("f", ["1"])[0]))
                    from PIL import Image
                    buf = io.BytesIO()
                    Image.fromarray(
                        (np.clip(img, 0, 1) * 255).astype(np.uint8)
                    ).save(buf, "PNG")
                    body = buf.getvalue()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_response(404)
                self.end_headers()

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_port

    def serve_forever(self):
        print(f"viewer at http://localhost:{self.port}", flush=True)
        self._httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._httpd.shutdown()


def _overlay_instances(img: np.ndarray, cams, instances, aabbs) -> np.ndarray:
    """Splat instance-coloured cluster points (and AABB wireframes) over a
    rendered view — the headless analogue of the reference's debug cluster
    viewers (segmentation/segmenter.py:187-204 viser point clouds,
    evaluation/vis_semantic_seg.py:39-178 instance colours).

    ``instances``: (points [N,3], colors [N,3] in [0,1]) in the model
    frame; ``aabbs``: [M, 2, 3] boxes drawn as white wireframes.  Painter's
    order by depth (far → near); no occlusion against the NeRF surface —
    this is a debug overlay, same as the reference viewers."""
    from ..counting.depth_projection import (project_points,
                                             projection_matrix)
    h, w = img.shape[:2]
    out = img * 0.45                      # dim the base render
    P = projection_matrix(float(cams.fx[0]), float(cams.fy[0]),
                          float(cams.cx[0]), float(cams.cy[0]),
                          np.asarray(cams.c2w[0]))
    pts_list, col_list = [], []
    if instances is not None:
        p, c = instances
        pts_list.append(np.asarray(p, np.float64))
        col_list.append(np.asarray(c, np.float32))
    if aabbs is not None:
        t = np.linspace(0.0, 1.0, 48)
        for box in np.asarray(aabbs, np.float64):
            corners = np.array([[box[i][0], box[j][1], box[k][2]]
                                for i in (0, 1) for j in (0, 1)
                                for k in (0, 1)])
            edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3),
                     (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
            seg = np.concatenate([
                corners[a][None] * (1 - t[:, None]) + corners[b][None]
                * t[:, None] for a, b in edges])
            pts_list.append(seg)
            col_list.append(np.ones((len(seg), 3), np.float32))
    if not pts_list:
        return img
    pts = np.concatenate(pts_list)
    cols = np.concatenate(col_list)
    # project_points returns (horizontal u, vertical v, depth) — the
    # reference's (ys, xs) naming is swapped; see zbuffer()'s width clip
    u, v, z = project_points(P, pts)
    ok = (z > 1e-6) & (u >= 0) & (u < w - 1) & (v >= 0) & (v < h - 1)
    u, v, z, cols = u[ok], v[ok], z[ok], cols[ok]
    order = np.argsort(-z)                # far first → near wins
    u, v, cols = u[order], v[order], cols[order]
    for dy in (0, 1):                     # 2x2 splats read at low res
        for dx in (0, 1):
            out[v + dy, u + dx] = cols
    return out


def make_model_renderer(params, cfg, size: int = 256, focal: float = 300.0,
                        center=(0.0, 0.0, 0.0), hessian=None,
                        uncertainty_lod: int = 8,
                        uncertainty_n_samples: int = 1000,
                        instances=None, aabbs=None,
                        compute_dtype: torch.dtype = torch.bfloat16):
    """Bind a trained model to the viewer's render callback:
    ``render_image(theta, phi, radius, channel="rgb", unc_filter=1.0)``
    → [size, size, 3] float image, rendered on the parameters' device.

    With a BayesRays ``hessian`` grid, the extra channel "uncertainty"
    renders the per-ray uncertainty map, and the page's *filter* slider
    suppresses density wherever pointwise uncertainty exceeds the slider
    value — uncertainty-filtered rendering of every channel (≙ the
    reference's uncertainty viewer and filter slider).  The threshold is a
    plain float given per call.

    ``instances`` (points, colors) / ``aabbs`` [M,2,3] expose an
    "instances" channel: the rgb render dimmed with the counted instance
    cloud and cluster boxes splatted on top (≙ the reference's cluster
    debug viewers).  Without artifacts the channel falls back to plain
    rgb."""
    from ..core.cameras import camera_ray_grid, near_far_collider
    from ..core.rays import RayBundle
    from ..evaluation.render_video import orbit_cameras
    from ..train.step import make_render_fn

    device = params.camera_opt.device
    hook = None
    if hessian is not None:
        from ..uncertainty.bayesrays import (make_uncertainty_density_hook,
                                             render_uncertainty)
        hessian = torch.as_tensor(np.asarray(hessian), device=device)
        hook = make_uncertainty_density_hook(
            hessian, cfg.model, uncertainty_lod, uncertainty_n_samples)
    render = make_render_fn(cfg, compute_dtype=compute_dtype,
                            density_hook=hook)

    @torch.no_grad()
    def unc_fn(cams):
        origins, dirs = camera_ray_grid(cams, 0, size, size)
        zeros = torch.zeros_like(origins[:, 0])
        rb = RayBundle(origins=origins, directions=dirs, nears=zeros,
                       fars=torch.ones_like(zeros),
                       camera_idx=torch.zeros_like(zeros, dtype=torch.long))
        rb = near_far_collider(rb, cfg.model.near_plane, cfg.model.far_plane)
        u = render_uncertainty(params, rb, cfg.model, hessian,
                               uncertainty_lod, uncertainty_n_samples,
                               compute_dtype=compute_dtype)
        return u.reshape(size, size)

    def render_image(theta: float, phi: float, radius: float,
                     channel: str = "rgb",
                     unc_filter: float = 1.0) -> np.ndarray:
        eye_h = radius * float(np.sin(phi))
        r_xy = radius * float(np.cos(phi))
        # one-camera "orbit" at the requested angle
        cams = orbit_cameras(1, radius=r_xy, height=eye_h, center=center,
                             focal=focal, width=size, image_height=size,
                             device=device)
        # rotate by theta: orbit_cameras places camera 0 at angle 0
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        c2w = np.einsum("ij,njk->nik", rot, cams.c2w.cpu().numpy())
        cams = dataclasses.replace(cams,
                                   c2w=torch.from_numpy(c2w).to(device))
        if channel == "uncertainty" and hessian is not None:
            img = unc_fn(cams).cpu().numpy()[..., None]
        elif channel == "instances":
            out = render(params, cams, 0, size, size, float(unc_filter))
            host = dataclasses.replace(
                cams, **{f.name: getattr(cams, f.name).cpu()
                         for f in dataclasses.fields(cams)
                         if getattr(cams, f.name) is not None})
            img = _overlay_instances(out["rgb"].cpu().numpy(), host,
                                     instances, aabbs)
        else:
            out = render(params, cams, 0, size, size, float(unc_filter))
            img = out[channel].cpu().numpy()
        if img.shape[-1] == 1:
            m = img.max() or 1.0
            img = np.repeat(img / m, 3, axis=-1)
        return img

    return render_image
