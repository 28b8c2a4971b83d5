"""The check that decides ``correct``: the frames the timed path
rendered, against the plain reference (:mod:`benchmark.reference`) run
on the same inputs.

A ray-sharded cell is judged on the same numbers: its ranks' rows of
each checked frame (the image rows, the aux images, the dense GI table's
and the denoiser history's rows) assembled to the whole frame, the
output as rank 0 presented it, against the reference's whole frame on
the sharded frame's sun route (``fused_sun=False``).

The reference builds its own scene from the run's ``.vox`` bytes and
replays the edits that the program had applied before each checked frame;
it bakes its own sky and cameras. A frame's state carries every frame
before it, so the reference renders each checked window frame from the
program's state on entry to that frame (copied to the host when the
window closed): it follows the program step by step. The start, the
first frame from a fresh state, it renders from a state of its own
making. Each checked frame is judged on the program's output image,
its auxiliary buffers (the G-buffer, the shading terms, the exposure)
and the state it hands on (the GI cache, the denoiser's history, the
exposure average).

Numbers, each the largest over the checked frames:

* ``id_mismatch``: the share of pixels whose voxel id differs (the
  primary trace);
* ``gbuffer_rel``: the relative L2 gap of depth, normal and albedo;
* ``shading_rel``: that of the radiance and the hit distance (GI and
  shading);
* ``output_rel``: that of the output image and the exposure (denoise,
  exposure, tonemap);
* ``state_rel``: that of the state handed on, every word decoded: the
  cache's radiance and sample counts, the denoiser's colour, fast
  luminance, hit distance, history length, depth and normal, the
  exposure average (and the hash frame's surfel pool and working set);
* ``hash_slots`` (the spatial hash): the share of the table's occupied
  slots whose fingerprint or last-access frame differs;
* ``state_words``: the 32-bit words that differ, compared exactly, of the
  state's frame index, previous view-projection and dense albedo
  column: handed on against the reference's, and on entry against what
  the reference derives itself (the run's frame count, the previous
  frame's camera, the replayed scene's leaf albedos). The step-by-step
  check cannot see a fault in these otherwise, since the reference reads
  them from the program's state;
* ``scene_words`` (cells that edit): the 32-bit words of the scene's
  tables that differ from the reference's replay, after the window's
  edits.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import config as ref_config
from benchmark.reference.ops import camera as ref_camera
from benchmark.reference.ops import denoise as ref_denoise
from benchmark.reference.ops import gi_cache as ref_gi
from benchmark.reference.ops import packing as ref_packing
from benchmark.reference.ops import sky as ref_sky
from benchmark.reference.ops import spatial_hash as ref_hash
from benchmark.reference.render import pipeline as ref_pipeline
from benchmark.reference.render import scene as ref_scene
from benchmark.reference.vox import loader as ref_loader

SCENE_TABLES = ("cell_info", "mask_lo", "mask_hi", "leaf_origin",
                "avg_albedo", "voxel_attr", "hdda_l1", "hdda_l2", "hdda_mask")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64, with non-finite values read as 0."""
    a = torch.nan_to_num(a.double(), nan=0.0, posinf=0.0, neginf=0.0)
    b = torch.nan_to_num(b.double(), nan=0.0, posinf=0.0, neginf=0.0)
    den = float(torch.linalg.vector_norm(b))
    num = float(torch.linalg.vector_norm(a - b))
    return num / den if den > 0.0 else num


def _state_views(state) -> list[torch.Tensor]:
    """Every field of a frame state that the next frame reads, decoded to
    floats; the integer words that ``state_words`` and ``hash_slots``
    compare exactly are left out."""
    table = state.gi.table
    if table.shape[1] == 16:
        cache = ref_hash.SpatialHash(table=table)
        views = [ref_packing.decode_logluv(cache.radiance),
                 cache.sample_count.float(), state.surfels]
    else:
        cache = ref_gi.DenseGICache(table=table)
        views = [cache.radiance, cache.count]
    if state.gi_ws is not None:
        ws = ref_gi.DenseGICache(table=state.gi_ws.table)
        views += [ws.radiance, ws.count]
    hist = ref_denoise._unpack_history(state.denoiser.history)
    return views + [hist[k] for k in ("color", "fast", "length", "hd",
                                      "depth", "oct")] + [
        state.exposure_avg.reshape(1)]


def words_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """32-bit words of ``a`` that differ from ``b``'s (all of them when the
    shapes differ)."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    a, b = a.contiguous(), b.to(a.device).contiguous()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def _albedo_columns(state) -> list[torch.Tensor]:
    cols = []
    if state.gi.table.shape[1] == 3:
        cols.append(state.gi.table[:, 2])
    if state.gi_ws is not None:
        cols.append(state.gi_ws.table[:, 2])
    return cols


def state_words(a, b) -> int:
    """Differing words of the exactly compared fields of two states."""
    n = int(a.frame_index != b.frame_index)
    n += words_differ(a.prev_view_proj, b.prev_view_proj)
    return n + sum(words_differ(x, y) for x, y in zip(_albedo_columns(a),
                                                      _albedo_columns(b)))


def hash_slots(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of occupied slots (in either table) whose fingerprint or
    last-access frame differs."""
    if a.shape != b.shape:
        return 1.0
    ha, hb = ref_hash.SpatialHash(table=a), ref_hash.SpatialHash(table=b)
    fa, fb = ha.fingerprint, hb.fingerprint
    used = (fa != 0) | (fb != 0)
    bad = used & ((fa != fb) | (ha.last_frame != hb.last_frame))
    return float(bad.sum()) / max(int(used.sum()), 1)


def frame_numbers(prog: dict, ref: dict) -> dict:
    """The numbers of one checked frame; ``prog`` and ``ref`` each hold
    ``out``, ``aux`` and ``state`` (on one device)."""
    pa, ra = prog["aux"], ref["aux"]
    ps, rs = prog["state"], ref["state"]
    nums = dict(
        id_mismatch=float((pa["voxel_id"] != ra["voxel_id"]).double().mean()),
        gbuffer_rel=max(rel_l2(pa[k], ra[k])
                        for k in ("depth", "normal", "albedo")),
        shading_rel=max(rel_l2(pa[k], ra[k]) for k in ("radiance", "hitdist")),
        output_rel=max(rel_l2(prog["out"], ref["out"]),
                       rel_l2(pa["exposure"], ra["exposure"])),
        state_rel=max(rel_l2(a, b) for a, b in zip(_state_views(ps),
                                                   _state_views(rs))),
        state_words=float(state_words(ps, rs)),
    )
    if ps.gi.table.shape[1] == 16:
        nums["hash_slots"] = hash_slots(ps.gi.table, rs.gi.table)
    return nums


def scene_words(prog_scene, ref_scene_) -> float:
    """Differing 32-bit words of the scene tables the frame reads."""
    n = 0
    for name in SCENE_TABLES:
        a, b = getattr(prog_scene, name), getattr(ref_scene_, name)
        if a.shape != b.shape:
            return float(max(a.numel(), b.numel()))
        n += int((a.to(b.device) != b).sum())
    return float(n)


def to_ref_state(state, device):
    """A program frame state (copied to the host) as the reference's."""
    def dev(t):
        return t.to(device)

    table = dev(state.gi.table)
    gi = (ref_hash.SpatialHash(table=table) if table.shape[1] == 16
          else ref_gi.DenseGICache(table=table))
    ws = state.gi_ws
    return ref_pipeline.FrameState(
        gi=gi, surfels=dev(state.surfels),
        denoiser=ref_denoise.DenoiserState(history=dev(state.denoiser.history)),
        exposure_avg=dev(state.exposure_avg), frame_index=state.frame_index,
        prev_view_proj=dev(state.prev_view_proj),
        gi_ws=None if ws is None else ref_gi.DenseGICache(table=dev(ws.table)))


@dataclasses.dataclass
class Reference:
    """The reference's scene and frame for one cell and seed."""

    config: dict
    traffic: dict
    path: inputs.Motion
    scene_bytes: bytes
    device: torch.device
    fused_sun: bool = True  # False: the ray-sharded frame's sun route

    def __post_init__(self):
        self.settings = self._settings()
        self.vox = ref_loader.load_vox_scene(self.scene_bytes)
        self.scene = ref_scene.build_device_scene(self.vox, self.device)
        self.base_o2w = self.scene.obj_to_world.cpu().numpy()
        self.sky = ref_sky.bake_sky(self.settings.sunlight, self.device)
        cos, scalar = inputs.blue_noise_tables()
        self.bn_cosine = torch.as_tensor(cos, device=self.device)
        self.bn_scalar = torch.as_tensor(scalar, device=self.device)
        self._edited: dict = {}

    def _settings(self):
        from benchmark.spec import render_settings

        return render_settings(ref_config.RenderSettings, self.config,
                               self.traffic)

    def scene_after(self, edits: list) -> object:
        """The scene with ``edits`` (in order) applied: each edited
        model rebuilt from its voxels and spliced into the first build."""
        key = len(edits)
        if key in self._edited:
            return self._edited[key]
        scene = self.scene
        geos = [self.vox.geometries[m] for m in sorted(self.vox.geometries)]
        _, mat_cap = ref_scene.material_layout(geos)
        for model in sorted({e.model for e in edits}):
            name = self.config["scene"]["models"][model]["name"]
            coords, idx = inputs.model_voxels(self.config, name)
            vox = {tuple(c): int(i) for c, i in zip(coords.tolist(),
                                                    idx.tolist())}
            for e in edits:
                if e.model == model:
                    vox[e.coord] = e.palette
            c = np.array(list(vox.keys()), np.int64)
            p = np.array(list(vox.values()), np.int64)
            old = self.vox.geometries[model]
            geo = ref_loader.build_model_geometry(
                c, p, self.vox.palette, old.size, old.unit_size)
            scene = ref_scene.splice_model(scene, model, geo, mat_cap[model],
                                           self.vox.palette)
            if scene is None:
                raise RuntimeError("the replayed edits outgrew the scene")
        self._edited = {key: scene}
        return scene

    def fresh_state(self, scene):
        state = ref_pipeline.make_frame_state(self.settings, scene,
                                              self.device)
        return dataclasses.replace(state, frame_index=self.path.noise0)

    def camera(self, eye):
        s = self.settings
        return ref_camera.camera_settings(
            ref_camera.look_at(eye, inputs.TARGET), s.camera.fov,
            s.camera.near, s.camera.far, s.width, s.height, self.device)

    def entry_words(self, rec: dict, scene) -> int:
        """Differing words of the program's state on entry to ``rec``'s
        frame in what the reference derives itself: the frame index (the
        seed's offset plus the frames rendered before), the previous
        frame's view-projection and the dense albedo column of ``scene``
        (the replayed scene)."""
        state = rec["state_in"]
        if state is None:
            return 0
        n = int(state.frame_index != self.path.noise0 + rec["frame"])
        prev = self.camera(self.path.eye(rec["frame"] - 1))
        n += words_differ(state.prev_view_proj, prev.view_proj)
        if state.gi.table.shape[1] == 3:
            n += words_differ(state.gi.table[:, 2].to(self.device),
                              ref_gi._albedo_words(scene))
        return n

    def render(self, rec: dict, lowp: bool = False):
        """The reference's frame of record ``rec``: from the program's
        state on entry, or (the start) from a fresh state of its own."""
        scene = self.scene_after(rec["edits"])
        state = (self.fresh_state(scene) if rec["state_in"] is None
                 else to_ref_state(rec["state_in"], self.device))
        if rec["o2w"] is not None:
            scene = scene.with_transforms(rec["prev_o2w"]).with_transforms(
                rec["o2w"])
        cam = self.camera(rec["eye"])
        out, aux, new_state = ref_pipeline.render_frame(
            scene, state, cam, self.sky, self.bn_cosine, self.bn_scalar,
            self.settings, lowp=lowp, fused_sun=self.fused_sun)
        return dict(out=out, aux=aux, state=new_state), scene


def control(ref: Reference, records: list) -> dict:
    """The control's numbers: the reference in bfloat16 put in the
    program's place, judged against the reference on the same inputs."""
    worst: dict = {}
    for rec in records:
        want, _scene = ref.render(rec)
        got, _scene = ref.render(rec, lowp=True)
        for k, v in frame_numbers(got, want).items():
            worst[k] = max(worst.get(k, 0.0), v)
        del want, got
    return worst


def check(ref: Reference, records: list) -> dict:
    """The numbers of every checked record (the largest of each), each
    record's program outputs moved to the reference's device one at a
    time."""
    worst: dict = {}
    for rec in records:
        t = time.perf_counter()
        got, scene = ref.render(rec)
        print(f"# reference frame {rec['frame']}: "
              f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
        prog = dict(out=rec["out"].to(ref.device),
                    aux={k: v.to(ref.device) for k, v in rec["aux"].items()},
                    state=to_ref_state(rec["state_out"], ref.device))
        nums = frame_numbers(prog, got)
        nums["state_words"] += ref.entry_words(rec, scene)
        if rec.get("scene") is not None:
            nums["scene_words"] = scene_words(rec["scene"], scene)
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
        del got, prog
    return worst
