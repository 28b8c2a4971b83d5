"""One run of one cell: set-up, the measured window, the traced slice,
the check against the reference, and the result line.

The window is a closed loop, as an interactive renderer runs: each
frame starts when the one before has been presented, a device
synchronisation standing in for present. In a cell that edits, each
frame first lands a staged splice whose build has finished
(``poll_refit``), then makes one brush edit (a palette change of an
existing voxel) and refits it at once, and, every ``splice_every``
frames with no splice in flight, places a voxel in a new leaf and stages
its splice (``refit_async``). While a splice is in flight the editor
refuses a refit, so brush edits wait, pending, for the first refit after
the swap. An edit's latency runs from its submission to the end of the
first frame rendered from a scene that holds it.

Under a mesh (a ray-sharded cell, ``benchmark/ranks.py``) every rank
runs this loop over the same frames: the scene built from the run's
bytes and replicated from rank 0 (``parallel.replicate_scene``: each
rank's own build gives the host fields and the shapes the broadcast
fills), the first state made whole and sharded
(``parallel.shard_frame_state``), each frame rendered with the mesh.
Present is the image assembled on rank 0 (``parallel.gather_image``),
each rank's device synchronised, and rank 0's decision whether the
window has closed carried to every rank (one broadcast of a flag). Rank
0 alone runs the profiler; after the window the checked frames are
assembled whole on rank 0 (:func:`host_records`) and checked there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import torch
import torch.distributed as dist

from benchmark import check as checklib
from benchmark import devtrace, inputs, work
from benchmark.spec import Cell, render_settings

SLICE_START = 4  # window frames before the traced slice begins
SEEDED_CHECK_FRAMES = 16  # the seeded checked frame is one of the first


def _copy(x, device=None):
    """``x`` with each of its tensors copied (dataclasses, named tuples
    and dicts followed): to ``device``, or where it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device or x.device, copy=True)
    if isinstance(x, dict):
        return {k: _copy(v, device) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _copy(getattr(x, f.name), device)
            for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_copy(v, device) for v in x))
    return x


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: Cell
    setup_s: float = 0.0
    scene_build_s: float = 0.0
    t0: float = 0.0
    ends: list = dataclasses.field(default_factory=list)
    edit_latencies_s: list = dataclasses.field(default_factory=list)
    edit_call_s: float = 0.0
    splice_swaps: list = dataclasses.field(default_factory=list)
    trace: devtrace.Slice | None = None
    hdda_launches: int = 0
    hdda_least_s: float | None = None
    unlanded: int = 0

    @property
    def frames(self) -> int:
        return len(self.ends)


class Frames:
    """The program's frame loop of one cell: scene, editor, state,
    camera path and edit stream; ``step()`` renders one frame. ``mesh``:
    this rank's ``dust_tpu_torch.parallel.Mesh`` (module docstring)."""

    def __init__(self, cell: Cell, seed: int, device, run: Run, mesh=None):
        from dust_tpu_torch import parallel
        from dust_tpu_torch.config import RenderSettings
        from dust_tpu_torch.ops import camera as cameralib
        from dust_tpu_torch.ops.sky import bake_sky
        from dust_tpu_torch.render.pipeline import (make_frame_state,
                                                    render_frame)
        from dust_tpu_torch.render.scene import build_device_scene
        from dust_tpu_torch.vox.loader import load_vox_scene

        self.cell, self.device, self.run, self.mesh = cell, device, run, mesh
        self.cameralib, self.render_frame = cameralib, render_frame
        self.parallel = parallel
        self.path = inputs.Motion(cell.traffic, seed)
        self.settings = render_settings(RenderSettings, cell.config,
                                        cell.traffic)
        self.scene_bytes = inputs.scene_bytes(cell.config)
        t = time.perf_counter()
        self.vox = load_vox_scene(self.scene_bytes)
        self.scene = build_device_scene(self.vox, device)
        if mesh is not None:
            self.scene = parallel.replicate_scene(self.scene, mesh)
        self.sync()
        run.scene_build_s = time.perf_counter() - t
        self.sky = bake_sky(self.settings.sunlight, device)
        cos, scalar = inputs.blue_noise_tables()
        self.bn_cosine = torch.as_tensor(cos, device=device)
        self.bn_scalar = torch.as_tensor(scalar, device=device)
        state = make_frame_state(self.settings, self.scene, device)
        if mesh is not None:
            state = parallel.shard_frame_state(state, mesh)
        self.state = dataclasses.replace(state, frame_index=self.path.noise0)
        names = [m["name"] for m in cell.config["scene"]["models"]]
        self.anim = (names.index(cell.config["scene"]["animated"])
                     if self.path.animated() else None)
        self.base_o2w = self.scene.obj_to_world.cpu().numpy()
        self.o2w = self.base_o2w
        self.cam = None if cell.traffic["camera"]["path"] == "orbit" \
            else self.camera(0)
        self.editor = self.stream = None
        if cell.traffic["edits"]:
            from dust_tpu_torch.render.edits import SceneEditor

            self.editor = SceneEditor(self.vox, self.scene)
            self.stream = inputs.EditStream(cell.config, cell.traffic, seed)
        self.frame = 0
        self.edits: list = []        # every edit, in submission order
        self.submitted: list = []    # host time of each submission
        self.applied = 0             # edits[:applied] are in the scene
        self.staged: tuple | None = None  # (edit index, frame) in flight
        self.timing = False          # count latencies and editor time
        self.window_edit0 = 1 << 62  # the first edit submitted in the window
        self.landed: list = []       # edits that land in this frame
        self.keep: set = set()       # frames whose record is kept
        self.records: dict = {}
        self.close_at = math.inf     # rank 0's clock: the window's end
        self.closed = False          # mesh: rank 0 saw the window close
        if mesh is not None:         # the flag that carries it
            self.flag = torch.zeros(1, dtype=torch.int32, device=device)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def present_sharded(self, out):
        """Present under the mesh: the whole image on rank 0 (None on the
        other ranks), every rank's work for the frame done, and rank 0's
        decision whether the window has closed on every rank."""
        mesh = self.mesh
        out = self.parallel.gather_image(mesh, out, self.settings.height)
        self.sync()
        if mesh.rank == 0:
            self.closed = time.perf_counter() >= self.close_at
            self.flag.fill_(int(self.closed))
        dist.broadcast(self.flag, src=0, group=mesh.group)
        if mesh.rank != 0:
            self.closed = bool(self.flag.item())
            out = None
        return out

    def camera(self, frame: int):
        s = self.settings
        return self.cameralib.camera_settings(
            self.cameralib.look_at(self.path.eye(frame), inputs.TARGET),
            s.camera.fov, s.camera.near, s.camera.far, s.width, s.height,
            self.device)

    # ------------------------------------------------------------ edits
    def _submit(self, edit: inputs.Edit) -> int:
        self.edits.append(edit)
        self.submitted.append(time.perf_counter())
        self.editor.set_voxels(edit.model, [edit.coord], edit.palette)
        return len(self.edits) - 1

    def _land(self, upto: int):
        """Edits below ``upto`` are now in the scene."""
        if upto < self.applied:
            raise RuntimeError("edits landed out of submission order")
        self.landed += [i for i in range(self.applied, upto)
                        if i >= self.window_edit0]
        self.applied = upto

    def edit_step(self, block: bool = False):
        """This frame's edits (module docstring); ``block`` waits for a
        staged splice."""
        ed, t = self.editor, time.perf_counter()
        if ed.refit_in_flight:
            landed = ed.poll_refit(self.state, block=block)
            if landed is not None:
                self.scene, self.state = landed
                if ed.last_refit_mode != "splice":
                    raise RuntimeError(f"a staged edit took the "
                                       f"{ed.last_refit_mode} tier")
                idx, f0 = self.staged
                self._land(idx + 1)
                if self.timing:
                    self.run.splice_swaps.append(self.frame - f0)
                self.staged = None
        if block:
            return
        self._submit(self.stream.brush_edit(self.frame))
        if not ed.refit_in_flight:
            self.scene, self.state = ed.refit(self.state)
            if ed.last_refit_mode != "leaf":
                raise RuntimeError(f"a brush edit took the "
                                   f"{ed.last_refit_mode} tier")
            self._land(len(self.edits))
        if (not ed.refit_in_flight
                and self.frame % self.cell.traffic["edits"]["splice_every"] == 0):
            idx = self._submit(self.stream.block_edit())
            if ed.refit_async(self.state) is not None:
                raise RuntimeError("a new-leaf edit did not stage a splice")
            self.staged = (idx, self.frame)
        if self.timing:
            self.run.edit_call_s += time.perf_counter() - t

    # ------------------------------------------------------------ frame
    def step(self, mark=contextlib.nullcontext, edits: bool = True) -> float:
        """One frame, presented; returns the host time of its end."""
        f = self.frame
        with mark("bench.frame"):
            if self.editor is not None and edits:
                with mark("bench.edits"):
                    self.edit_step()
            prev_o2w = self.o2w
            if self.anim is not None:
                self.o2w = self.path.obj_to_world(self.base_o2w, self.anim, f)
                self.scene = self.scene.with_transforms(self.o2w)
            cam = self.cam if self.cam is not None else self.camera(f)
            state_in = self.state
            kept = f in self.keep
            if kept:  # a copy: the frame may update its state in place
                state_in = _copy(state_in)
            out, aux, self.state = self.render_frame(
                self.scene, self.state, cam, self.sky, self.bn_cosine,
                self.bn_scalar, self.settings, return_aux=True, mesh=self.mesh)
            with mark("bench.present"):
                if self.mesh is None:
                    self.sync()
                else:
                    out = self.present_sharded(out)
        end = time.perf_counter()
        self.run.edit_latencies_s += [end - self.submitted[i]
                                      for i in self.landed]
        self.landed = []
        if kept:  # copies: a later frame may reuse these buffers
            out, aux, state_out = _copy(out), _copy(aux), _copy(self.state)
            self.records[f] = dict(
                frame=f, eye=self.path.eye(f),
                o2w=None if self.anim is None else self.o2w,
                prev_o2w=None if self.anim is None else prev_o2w,
                edits=self.edits[:self.applied], state_in=state_in,
                out=out, aux=aux, state_out=state_out)
        self.frame += 1
        return end

    def drain(self) -> float:
        """After the window: land a splice still in flight and every
        pending edit, and render one frame from the scene that holds them
        all (its end counts in those edits' latencies)."""
        if self.editor.refit_in_flight:
            self.edit_step(block=True)
        if self.applied < len(self.edits):
            self.scene, self.state = self.editor.refit(self.state)
            self._land(len(self.edits))
        return self.step(edits=False)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, mesh=None) -> tuple[Run, dict, Frames]:
    """Set-up, window and (with ``trace``) the traced slice, which rank 0
    alone profiles under a mesh. Returns the run, the records of the
    checked frames and the loop."""
    run = Run(cell=cell)
    loop = Frames(cell, seed, device, run, mesh)
    traffic = cell.traffic
    # Warm-up: the cell's own frames, edits and (edits) a landed splice.
    checked = cell.check["frames"]
    loop.keep.add(0)
    for k in range(traffic["warmup_frames"]):
        loop.step()
        if k == 0 and loop.editor is not None and loop.editor.refit_in_flight:
            loop.edit_step(block=True)
    loop.sync()
    if "start" in checked:
        loop.records[0]["state_in"] = None  # the reference makes its own
    else:
        del loop.records[0]
    loop.window_edit0 = len(loop.edits)
    first = loop.frame
    seeded = first + int(inputs.rng_for(seed, 2).integers(
        0, SEEDED_CHECK_FRAMES))
    if "seeded" in checked:
        loop.keep.add(seeded)
    run.setup_s = time.perf_counter() - t_start

    from dust_tpu_torch.ops import hdda
    from torch.profiler import ProfilerActivity, profile, record_function

    loop.timing = True
    prof = None
    slice_frames = traffic["trace_frames"]
    profiling = trace and (mesh is None or mesh.rank == 0)
    run.t0 = time.perf_counter()
    loop.close_at = run.t0 + seconds
    while True:
        k = loop.frame - first
        if profiling and k == SLICE_START:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            launches0 = sum(hdda.LAUNCHES.values())
            slice_mark = record_function(devtrace.SLICE)
            slice_mark.__enter__()
        mark = record_function if prof is not None else contextlib.nullcontext
        run.ends.append(loop.step(mark))
        if prof is not None and k == SLICE_START + slice_frames - 1:
            slice_mark.__exit__(None, None, None)
            run.hdda_launches = sum(hdda.LAUNCHES.values()) - launches0
            prof.__exit__(None, None, None)
            run.trace = devtrace.read(prof, slice_frames)
            prof = None
        closed = (run.ends[-1] - run.t0 >= seconds if mesh is None
                  else loop.closed)
        if closed and (not trace or k >= SLICE_START + slice_frames - 1):
            break
    # The first frame after the window: checked as "after", and in place
    # of the seeded frame when the window closed before it. In a cell
    # that edits, it first lands every edit still staged or pending.
    after = loop.frame
    if "after" in checked or ("seeded" in checked and seeded >= after):
        loop.keep.add(after)
    if loop.editor is not None:
        calls = run.edit_call_s
        loop.drain()
        run.edit_call_s = calls
        run.unlanded = len(loop.edits) - loop.applied
        if after in loop.records:
            loop.records[after]["scene"] = loop.scene
    elif after in loop.keep:
        loop.step()
    loop.timing = False
    return run, loop.records, loop


def _whole_rows(mesh, t: torch.Tensor):
    """Every rank's rows of ``t``, in rank order, on rank 0's host (None
    on the other ranks): two all-gathers of the harness's own, the row
    counts and the rows padded to the most."""
    dev = mesh.device
    counts = [torch.zeros(1, dtype=torch.int64, device=dev)
              for _ in range(mesh.size)]
    dist.all_gather(counts, torch.tensor([t.shape[0]], device=dev),
                    group=mesh.group)
    counts = [int(c) for c in counts]
    x = t.to(dev).contiguous()
    if max(counts) > x.shape[0]:
        x = torch.cat([x, x.new_zeros((max(counts) - x.shape[0],)
                                      + x.shape[1:])])
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    if mesh.rank != 0:
        return None
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).cpu()


def _whole_state(mesh, state):
    """A sharded frame state made whole on rank 0's host: the dense GI
    table's and the denoiser history's rows from every rank
    (``parallel.shard_frame_state``'s layout), every replicated field
    from rank 0."""
    if state is None:
        return None
    table = state.gi.table
    table = (_whole_rows(mesh, table) if table.shape[1] == 3
             else table.cpu())
    history = _whole_rows(mesh, state.denoiser.history)
    if mesh.rank != 0:
        return None
    return _copy(dataclasses.replace(
        state, gi=type(state.gi)(table=table),
        denoiser=type(state.denoiser)(history=history)), "cpu")


def _whole_record(mesh, rec: dict) -> dict | None:
    """One checked frame's record made whole on rank 0's host: the aux
    images' rows from every rank (a scalar, the exposure, from rank 0),
    both states whole; the output is the image rank 0 presented."""
    aux = {k: v.cpu() if v.dim() == 0 else _whole_rows(mesh, v)
           for k, v in rec["aux"].items()}
    state_in = _whole_state(mesh, rec["state_in"])
    state_out = _whole_state(mesh, rec["state_out"])
    if mesh.rank != 0:
        return None
    rest = {k: v for k, v in rec.items()
            if k not in ("aux", "state_in", "state_out")}
    return dict(_copy(rest, "cpu"), aux=aux, state_in=state_in,
                state_out=state_out)


def host_records(loop: Frames, records: dict) -> list:
    """The checked frames' inputs and outputs copied to the host, in frame
    order; the program's own objects (scene, editor, state) are dropped.
    Under a mesh every rank takes part, and the records, whole, are rank
    0's (none on the other ranks)."""
    if loop.mesh is None:
        recs = [_copy(dict(records[f]), "cpu") for f in sorted(records)]
    else:
        recs = [_whole_record(loop.mesh, records[f]) for f in sorted(records)]
        recs = [] if loop.mesh.rank != 0 else recs
    records.clear()
    for name in ("scene", "state", "editor", "vox", "records"):
        loop.__dict__.pop(name, None)
    if loop.device.type == "cuda":
        torch.cuda.empty_cache()
    return recs


def reference(cell: Cell, loop: Frames, device) -> checklib.Reference:
    """The check's reference for ``loop``'s run, on the sharded frame's
    sun route for a ray-sharded cell."""
    return checklib.Reference(cell.config, cell.traffic, loop.path,
                              loop.scene_bytes, device,
                              fused_sun=not cell.sharded)


def hdda_least_s(ref: checklib.Reference, mesh=None) -> float:
    """The least time of a frame's HDDA launches on the reference's scene
    (rank 0's launches under ``mesh``), for the roofline."""
    least, _bound_by = work.least_time_s(
        work.hdda_passes(ref.scene, ref.settings,
                         None if mesh is None else mesh.size),
        work.model_leaves(ref.scene), ref.scene.num_instances)
    return least


def check_records(cell: Cell, loop: Frames, records: dict, device,
                  run: Run) -> dict:
    """The program's checked frames against the reference, and the
    frame's HDDA least time for the roofline (one card; a sharded run
    checks on rank 0, ``benchmark/ranks.py``)."""
    recs = host_records(loop, records)
    ref = reference(cell, loop, device)
    run.hdda_least_s = hdda_least_s(ref)
    return checklib.check(ref, recs)
