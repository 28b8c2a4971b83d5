"""The port's spans. ``utils.profiling.trace_annotation`` returns one
shared no-op with no profiler running and a ``torch.profiler`` range with
one. Under a profiler ``render_frame`` opens ``dust.frame``, the stages
it runs inside it, in order and apart, and the HDDA wrapper one
``dust.hdda.<mode>`` per trace pass, inside the stage that traces. The
teapot at 96x54 on the kernel's backend (the plain HDDA walk on the CPU),
torch on one thread; a frame renders the same with and without a
profiler."""

import contextlib
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dust_tpu_torch import config
from dust_tpu_torch.ops import camera as cameralib
from dust_tpu_torch.ops.noise import load_blue_noise
from dust_tpu_torch.ops.sky import bake_sky
from dust_tpu_torch.render import pipeline
from dust_tpu_torch.render.scene import build_device_scene
from dust_tpu_torch.utils import profiling
from dust_tpu_torch.vox import procgen
from dust_tpu_torch.vox.loader import load_vox_scene

EYE, TARGET = (26.0, 14.0, 32.0), (4.0, -4.0, 0.0)
STAGES = ["dust.primary", "dust.sun", "dust.gather", "dust.refresh",
          "dust.post"]
# name -> (settings fields, stages, the stage of each trace pass in order)
FRAMES = {
    "dense_gi": (dict(), STAGES, [
        ("precise", "dust.primary"), ("ao_fg", "dust.sun"),
        ("ao_threshold", "dust.gather"), ("rough", "dust.gather"),
        ("rough", "dust.refresh"), ("rough", "dust.refresh")]),
    "primary_shadow": (dict(contribution_secondary_spatial_hash=False,
                            contribution_secondary_skylight=False,
                            contribution_secondary_sunlight=False),
                       ["dust.primary", "dust.sun", "dust.post"],
                       [("precise", "dust.primary"), ("ao_fg", "dust.sun")]),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    scene = build_device_scene(load_vox_scene(procgen.teapot_scene_bytes()),
                               "cpu")
    return dict(scene=scene, bn=load_blue_noise("cpu"))


def _settings(name):
    return config.RenderSettings(width=96, height=54, gi_cache="dense",
                                 traversal_backend="pallas",
                                 **FRAMES[name][0])


def _render(inputs, settings, frames=1):
    """``frames`` frames from a fresh state: (outputs, aux, state) of
    each."""
    scene, bn = inputs["scene"], inputs["bn"]
    cam = cameralib.camera_settings(
        cameralib.look_at(EYE, TARGET), 0.9, settings.camera.near,
        settings.camera.far, settings.width, settings.height, "cpu")
    sky = bake_sky(settings.sunlight, "cpu")
    state = pipeline.make_frame_state(settings, scene, "cpu")
    out = []
    for _ in range(frames):
        img, aux, state = pipeline.render_frame(
            scene, state, cam, sky, bn.unitvec3_cosine, bn.scalar, settings)
        out.append((img, aux, state))
    return out


def _spans(prof):
    """(start, end, name) of every ``dust.*`` range, in start order."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("dust.") and e.is_user_annotation())


def _tensors(x):
    """Every tensor of ``x``, dataclasses, tuples and dicts followed."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = [x[k] for k in sorted(x)]
    elif not isinstance(x, (tuple, list)):
        return []
    return [t for v in x for t in _tensors(v)]


def test_span_without_a_profiler_is_the_shared_no_op():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    off = profiling.trace_annotation("dust.off")
    assert isinstance(off, contextlib.nullcontext)
    assert off is profiling.trace_annotation("dust.other")
    with off:
        torch.ones(4).sum()
    assert not any(e.name() == "dust.off"
                   for e in prof.profiler.kineto_results.events())


def test_span_under_a_profiler_is_a_user_annotation():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = profiling.trace_annotation("dust.on")
        assert isinstance(on, torch.profiler.record_function)
        with on:
            torch.ones(4).sum()
    named = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "dust.on"]
    assert len(named) == 1 and named[0].is_user_annotation()
    assert named[0].activity_type() == "user_annotation"


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_spans(inputs, name):
    """One ``dust.frame``; the stages the frame runs, once each, in order,
    apart, inside it; each trace pass's ``dust.hdda.<mode>`` inside its
    stage."""
    _, stages, passes = FRAMES[name]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render(inputs, _settings(name))
    spans = _spans(prof)
    frame = [sp for sp in spans if sp[2] == "dust.frame"]
    assert len(frame) == 1
    f0, f1, _ = frame[0]
    steps = [sp for sp in spans if sp[2] in STAGES]
    assert [sp[2] for sp in steps] == stages
    assert all(f0 <= s < e <= f1 for s, e, _ in steps)
    assert all(a[1] <= b[0] for a, b in zip(steps, steps[1:]))
    traces = [sp for sp in spans if sp[2].startswith("dust.hdda.")]
    assert [sp[2] for sp in traces] == [f"dust.hdda.{m}" for m, _ in passes]
    for (s, e, _), (_, stage) in zip(traces, passes):
        assert [sp[2] for sp in steps if sp[0] <= s and e <= sp[1]] == [stage]
    assert len(spans) == 1 + len(steps) + len(traces)


def test_frame_is_the_same_under_a_profiler(inputs):
    """Two dense frames from a fresh state: outputs, aux and the state
    handed on equal with and without a profiler running."""
    settings = _settings("dense_gi")
    plain = _render(inputs, settings, frames=2)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _render(inputs, settings, frames=2)
    for a, b in zip(plain, traced):
        ta, tb = _tensors(a), _tensors(b)
        assert len(ta) == len(tb) > 10
        assert all(torch.equal(x, y) for x, y in zip(ta, tb))
    assert plain[-1][2].frame_index == traced[-1][2].frame_index == 2
