"""Per-subcluster semantic projections: occlusion-free and visibility
passes (counterpart of ``cropnerf_tpu/projection/project.py``, with its
artifact contract).

Equivalent of the reference's projection stage (the reference's
crop_nerf/fruit_nerf/fruit_nerf.py:254-344 and
scripts/semantic_projection.py:100-171):

  for supercluster s, camera c, subcluster i:
    * rays clipped to the subcluster AABB; fewer than 10 hits → zero images;
    * WO-OCC pass: the semantic output of the clipped rays (black
      background), clamped to [0, 1] → ``wo_occ_cluster_i.png``;
    * VISIBILITY pass: rays from the camera to the box entry
      (fars ← max(nears, 1e-4), nears ← 0); an accumulated density weight
      >= 0.5 marks the pixel occluded and zeroes it →
      ``visible_cluster_i.png``;
    * the GT instance-label image is copied into the camera directory.

The AABB is projected to a pixel crop rectangle (padded by 8 pixels) and
the whole crop is rendered with a hit mask.  PyTorch runs eagerly, so the
JAX module's bucket ladder and ahead-of-time compiles have no counterpart:
the crops of all jobs are laid end to end as one stream of rays and cut
into dispatches of at most ``min(rays_per_dispatch, max_rays_per_job)``
rays, so a crop larger than a dispatch is rendered in row-major pixel
segments and stitched, and each dispatch is one ``forward`` and one
``forward_accumulation`` on the device with one copy of its results back
to the host.  Every ray is computed on its own, so the images do not
depend on how the jobs are batched.

Across ranks (``mesh``) rank r renders dispatches r, r+N, ... of the same
plan; rank 0 gathers their results in dispatch order, stitches them and
writes the PNG tree, which is the one-rank tree byte for byte.
"""
from __future__ import annotations

import dataclasses
import shutil
import time
from pathlib import Path
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from ..core.cameras import Cameras, generate_rays, ray_aabb_intersect
from ..core.rays import RayBundle
from ..models.config import ModelConfig
from ..models.model import CropNeRFParams, forward, forward_accumulation
from ..parallel.mesh import Mesh, gather_in_order, main_rank

OCCLUSION_THRESHOLD = 0.5   # fruit_nerf.py:313
MIN_VALID_RAYS = 10         # fruit_nerf.py:293


class HostCameras(NamedTuple):
    """The cameras' poses and intrinsics as numpy arrays, read from the
    device once: c2w [N, 3, 4], fx, fy, cx, cy [N]."""
    c2w: np.ndarray
    fx: np.ndarray
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray


def host_cameras(cameras: Cameras) -> HostCameras:
    return HostCameras(*(t.detach().cpu().numpy() for t in (
        cameras.c2w, cameras.fx, cameras.fy, cameras.cx, cameras.cy)))


def _project_aabb_to_crop(cameras: HostCameras, cam_idx: int,
                          aabb: np.ndarray, height: int, width: int,
                          pad: int = 8) -> Optional[Tuple[int, int, int, int]]:
    """Conservative pixel bbox (x0, y0, x1, y1) of the AABB in the image,
    or None when the box is behind the camera or outside the frame."""
    c2w = cameras.c2w[cam_idx]
    fx = float(cameras.fx[cam_idx]); fy = float(cameras.fy[cam_idx])
    cx = float(cameras.cx[cam_idx]); cy = float(cameras.cy[cam_idx])
    corners = np.array([[aabb[i][0], aabb[j][1], aabb[k][2]]
                        for i in range(2) for j in range(2) for k in range(2)])
    R, t = c2w[:, :3], c2w[:, 3]
    cam_pts = (corners - t) @ R          # world → camera (R orthonormal)
    z = -cam_pts[:, 2]
    if np.all(z <= 1e-6):
        return None
    z = np.maximum(z, 1e-6)
    xs = cam_pts[:, 0] / z * fx + cx
    ys = -cam_pts[:, 1] / z * fy + cy
    x0 = max(0, int(np.floor(xs.min())) - pad)
    x1 = min(width, int(np.ceil(xs.max())) + pad)
    y0 = max(0, int(np.floor(ys.min())) - pad)
    y1 = min(height, int(np.ceil(ys.max())) + pad)
    if x1 <= x0 or y1 <= y0:
        return None
    return x0, y0, x1, y1


@dataclasses.dataclass
class _Job:
    index: int
    cam: int
    aabb: np.ndarray
    crop: Tuple[int, int, int, int]

    @property
    def n_pix(self) -> int:
        x0, y0, x1, y1 = self.crop
        return (x1 - x0) * (y1 - y0)


@dataclasses.dataclass
class ProjectionPlan:
    """How ``iter_projections`` renders a list of jobs: ``outside`` jobs
    whose box no pixel of the camera sees (zero images, no rays), the rest
    laid end to end as ``rays`` rays in ``dispatches`` dispatches of at
    most ``rays_per_call`` rays.  Each dispatch holds ``(job, start,
    stop)`` segments of its jobs' row-major crop pixels."""
    jobs: List[_Job]
    outside: List[int]
    dispatches: List[List[Tuple[int, int, int]]]
    rays_per_call: int

    @property
    def rays(self) -> int:
        return sum(j.n_pix for j in self.jobs)

    def summary(self) -> dict:
        return {"jobs": len(self.jobs) + len(self.outside),
                "outside": len(self.outside), "rays": self.rays,
                "dispatches": len(self.dispatches),
                "rays_per_dispatch": self.rays_per_call}


class ClusterProjector:
    """Renders (camera, AABB) jobs in flat ray dispatches.

    A dispatch holds at most ``min(rays_per_dispatch, max_rays_per_job)``
    rays, where ``max_rays_per_job`` keeps a dispatch under
    ``max_samples_per_dispatch`` field samples (every ray evaluates
    ``num_nerf_samples_per_ray + Σ num_proposal_samples_per_ray``)."""

    def __init__(self, params: CropNeRFParams, model_cfg: ModelConfig,
                 cameras: Cameras, height: int, width: int,
                 occlusion_threshold: float = OCCLUSION_THRESHOLD,
                 rays_per_dispatch: int = 262_144,
                 max_samples_per_dispatch: int = 8_388_608,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.params = params
        self.cfg = model_cfg
        self.cameras = cameras
        self.host = host_cameras(cameras)
        self.device = cameras.c2w.device
        self.height = height
        self.width = width
        self.occlusion_threshold = occlusion_threshold
        self.rays_per_dispatch = rays_per_dispatch
        self.compute_dtype = compute_dtype
        samples_per_ray = (model_cfg.num_nerf_samples_per_ray
                           + sum(model_cfg.num_proposal_samples_per_ray))
        self.max_rays_per_job = max(
            128, max_samples_per_dispatch // max(samples_per_ray, 1)
            // 128 * 128)

    def plan(self, jobs: Sequence[Tuple[int, np.ndarray]]) -> ProjectionPlan:
        """The crops of ``jobs`` and their cut into dispatches."""
        H, W = self.height, self.width
        placed, outside = [], []
        for idx, (cam_idx, aabb) in enumerate(jobs):
            crop = _project_aabb_to_crop(self.host, int(cam_idx),
                                         np.asarray(aabb), H, W)
            if crop is None:
                outside.append(idx)
            else:
                placed.append(_Job(idx, int(cam_idx),
                                   np.asarray(aabb, np.float32), crop))
        cap = min(self.rays_per_dispatch, self.max_rays_per_job)
        dispatches, current, room = [], [], cap
        for slot, job in enumerate(placed):
            start = 0
            while start < job.n_pix:
                stop = min(job.n_pix, start + room)
                current.append((slot, start, stop))
                room -= stop - start
                start = stop
                if room == 0:
                    dispatches.append(current)
                    current, room = [], cap
        if current:
            dispatches.append(current)
        return ProjectionPlan(placed, outside, dispatches, cap)

    @torch.no_grad()
    def _render(self, jobs: List[_Job], segments) -> np.ndarray:
        """One dispatch: [3, rays] (semantics × hit, occluded, hit) on the
        host, in the order of ``segments``."""
        dev = self.device
        table = torch.tensor(
            [[stop - start, start, jobs[s].crop[0], jobs[s].crop[1],
              jobs[s].crop[2] - jobs[s].crop[0], jobs[s].cam]
             for s, start, stop in segments], dtype=torch.long).to(dev)
        boxes = torch.from_numpy(np.stack(
            [jobs[s].aabb for s, _, _ in segments])).to(dev)
        n = sum(stop - start for _, start, stop in segments)
        length, start, x0, y0, cw, cam = table.unbind(1)
        seg = torch.repeat_interleave(
            torch.arange(len(segments), device=dev), length, output_size=n)
        first = torch.cumsum(length, 0) - length
        local = start[seg] + torch.arange(n, device=dev) - first[seg]
        cw = cw[seg]
        px, py, cam = x0[seg] + local % cw, y0[seg] + local // cw, cam[seg]
        origins, dirs = generate_rays(self.cameras, cam, px, py)
        nears, fars, hit = ray_aabb_intersect(
            origins, dirs, boxes[seg].transpose(0, 1))
        rb = RayBundle(origins=origins, directions=dirs, nears=nears,
                       fars=fars, camera_idx=cam, mask=hit)
        out = forward(self.params, rb, self.cfg, train=False,
                      background="black", compute_dtype=self.compute_dtype)
        semantics = out["semantics"][..., 0] * hit
        # visibility pass: camera → box entry
        rb_vis = rb.replace(nears=torch.zeros_like(nears),
                            fars=torch.clamp(nears, min=1e-4))
        acc = forward_accumulation(self.params, rb_vis, self.cfg,
                                   compute_dtype=self.compute_dtype)
        occluded = (acc >= self.occlusion_threshold) & (hit > 0)
        return torch.stack([semantics.float(), occluded.float(),
                            hit]).cpu().numpy()

    def iter_projections(self, jobs: Sequence[Tuple[int, np.ndarray]],
                         plan: Optional[ProjectionPlan] = None,
                         mesh: Optional[Mesh] = None
                         ) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """Render ``(cam_idx, aabb)`` jobs.

        Yields ``(job_index, wo_occ [H,W], visible [H,W])`` exactly once per
        job: the jobs no pixel sees first, then the others as their last
        dispatch completes, so the caller can stream results to disk
        without holding every full-size image.  ``mesh``: the dispatches
        split over the ranks; rank 0 yields every job, the other ranks
        render their dispatches and yield nothing.
        """
        H, W = self.height, self.width
        plan = plan if plan is not None else self.plan(jobs)

        def _zero(idx):
            return idx, np.zeros((H, W), np.float32), \
                np.zeros((H, W), np.float32)

        if main_rank(mesh):
            for idx in plan.outside:
                yield _zero(idx)
        placed = plan.jobs
        results = {}
        for d, res in gather_in_order(
                len(plan.dispatches),
                lambda d: self._render(placed, plan.dispatches[d]), mesh):
            segments = plan.dispatches[d]
            at = 0
            for slot, start, stop in segments:
                job = placed[slot]
                if slot not in results:
                    results[slot] = np.zeros((3, job.n_pix), np.float32)
                results[slot][:, start:stop] = res[:, at:at + stop - start]
                at += stop - start
                if stop < job.n_pix:
                    continue
                sem, occ, hit = results.pop(slot)
                if hit.sum() < MIN_VALID_RAYS:
                    yield _zero(job.index)
                    continue
                x0, y0, x1, y1 = job.crop
                cw, ch = x1 - x0, y1 - y0
                # the reference saves raw logits via save_image → clamp [0,1]
                sem_img = np.clip(sem.reshape(ch, cw), 0.0, 1.0)
                occ_img = occ.reshape(ch, cw) > 0
                wo_occ = np.zeros((H, W), np.float32)
                visible = np.zeros((H, W), np.float32)
                wo_occ[y0:y1, x0:x1] = sem_img
                visible[y0:y1, x0:x1] = np.where(occ_img, 0.0, sem_img)
                yield job.index, wo_occ, visible

    def project(self, cam_idx: int, aabb: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (wo_occ [H,W], visible [H,W]) float images in [0,1]."""
        _, wo_occ, visible = next(self.iter_projections([(cam_idx, aabb)]))
        return wo_occ, visible


def _save_gray(path: Path, img: np.ndarray) -> None:
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


@dataclasses.dataclass
class ProjectionReport:
    """What :func:`run_projections` did: the tree it wrote, its plan's
    summary, and its seconds split between rendering and PNG writing."""
    output_dir: Path
    plan: dict
    render_s: float
    png_s: float


def run_projections(params: CropNeRFParams, model_cfg: ModelConfig,
                    cameras: Cameras, height: int, width: int,
                    super_cluster_info: np.ndarray,
                    output_dir: Path,
                    label_paths: Optional[list] = None,
                    camera_indices: Optional[list] = None,
                    occlusion_threshold: float = OCCLUSION_THRESHOLD,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    mesh: Optional[Mesh] = None,
                    rays_per_dispatch: int = 262_144
                    ) -> ProjectionReport:
    """Write the full projection tree
    ``super_cluster_{s}/cam_{c}/{wo_occ,visible}_cluster_{i}.png``
    (and the copied GT label images) that the merger reads.  ``mesh``:
    the dispatches split over the ranks, and rank 0 writes the tree."""
    output_dir = Path(output_dir)
    n_cams = cameras.num_cameras
    cam_ids = camera_indices if camera_indices is not None else range(n_cams)
    if label_paths is not None and len(label_paths) <= max(cam_ids, default=0):
        raise ValueError(
            f"label_paths has {len(label_paths)} entries but camera indices "
            f"go up to {max(cam_ids)} — expected one label image per camera "
            "(sorted order must match the training-split frame order; pass "
            "label_paths=None to skip GT label copying)")
    projector = ClusterProjector(params, model_cfg, cameras, height, width,
                                 occlusion_threshold,
                                 rays_per_dispatch=rays_per_dispatch,
                                 compute_dtype=compute_dtype)

    # every (supercluster, camera, subcluster) job up front, so that the
    # dispatches fill across all of them; results stream to disk as their
    # dispatches complete
    jobs, dests = [], []
    writes = main_rank(mesh)
    for s, info in enumerate(super_cluster_info):
        aabbs = info["aabb"]
        for c in cam_ids:
            cam_dir = output_dir / f"super_cluster_{s}" / f"cam_{c}"
            if writes:
                cam_dir.mkdir(parents=True, exist_ok=True)
            for i in range(aabbs.shape[0]):
                jobs.append((int(c), aabbs[i]))
                dests.append((cam_dir, i))
            if label_paths is not None and writes:
                lp = Path(label_paths[c])
                if lp.exists():
                    name = (lp.name if lp.name.startswith("label_")
                            else f"label_{lp.name}")
                    shutil.copy(lp, cam_dir / name)

    plan = projector.plan(jobs)
    summary = plan.summary()
    if writes:
        print(f"[project] {summary['jobs']} jobs ({summary['outside']} "
              f"outside every view): {summary['rays']} rays in "
              f"{summary['dispatches']} dispatches of up to "
              f"{summary['rays_per_dispatch']} rays"
              + (f" over {mesh.size} ranks" if mesh is not None else ""),
              flush=True)
    t0 = time.perf_counter()
    t_io = 0.0
    for idx, wo_occ, visible in projector.iter_projections(jobs, plan, mesh):
        cam_dir, i = dests[idx]
        t1 = time.perf_counter()
        _save_gray(cam_dir / f"wo_occ_cluster_{i}.png", wo_occ)
        _save_gray(cam_dir / f"visible_cluster_{i}.png", visible)
        t_io += time.perf_counter() - t1
    render_s = time.perf_counter() - t0 - t_io
    if writes:
        print(f"[project] render+stitch {render_s:.1f}s, png io "
              f"{t_io:.1f}s", flush=True)
    return ProjectionReport(output_dir, summary, render_s, t_io)
