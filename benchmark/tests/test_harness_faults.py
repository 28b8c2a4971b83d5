"""A run with the timed path broken underneath comes out as not correct:
the rest of the run is the harness's own (the look for a card skipped,
a tiny size on the CPU). One test for each fault the cells can have. A
ray-sharded cell runs on 2 and 4 gloo ranks, each a process of its own,
and has the exchange between ranks to leave out (a rank's rows of the
presented image) and a rank's share of the state to drop (its rows of
the GI table, not handed on). Its sun route, two launches in place of
the fused one, is held by ``test_harness_work.py``: the fused walk
answered every sun ray tried alike, so no number can see a swap. Those
faults are
planted in every rank by a hook of this module, called with the mesh
before the run; so are a rank that raises and a rank that is killed,
which end the run with no result."""

import dataclasses
import os
import signal
import time

import pytest
import torch

from conftest import run_sharded_tiny, run_tiny, sharded_cell


def _state_unchanged(render):
    def frame(scene, state, *a, **k):
        out, aux, _new = render(scene, state, *a, **k)
        return out, aux, state
    return frame


def _half_left_out(render):
    """Half the frame's rays are never traced: they report misses."""
    from dust_tpu_torch.ops import hdda

    trace = hdda.trace_scene

    def half(scene, origin, direction, t_min, t_max, mode="precise"):
        res = trace(scene, origin, direction, t_min, t_max, mode)
        keep = torch.arange(origin.shape[0]) % 2 == 0
        return type(res)(t=torch.where(keep, res.t, float("inf")),
                         inst=torch.where(keep, res.inst, -1),
                         row=torch.where(keep, res.row, -1),
                         bit=torch.where(keep, res.bit, -1))
    return render, ("trace_scene", half)


def _answer_altered(render):
    """One 8x128 tile of each output image altered where it is made."""
    def frame(*a, **k):
        out, aux, state = render(*a, **k)
        out = out.clone()
        out[:8, :128] = 1.0 - out[:8, :128]
        return out, aux, state
    return frame


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("workload", ["dense-orbit-1080p",
                                      "dense-edits-1080p"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(monkeypatch, workload, fault):
    from dust_tpu_torch.ops import hdda
    from dust_tpu_torch.render import pipeline

    made = FAULTS[fault](pipeline.render_frame)
    if isinstance(made, tuple):
        frame, (name, fn) = made
        monkeypatch.setattr(hdda, name, fn)
    else:
        monkeypatch.setattr(pipeline, "render_frame", made)
    out, _run = run_tiny(workload, seed=2**31 + 23)
    assert not out["correct"], out["checks"]


def _state_field(change):
    """The frame hands on its new state with ``change(new, old)`` made:
    one field of the state left stale or corrupted."""
    def fault(render):
        def frame(scene, state, *a, **k):
            old = dataclasses.replace(
                state, gi=type(state.gi)(table=state.gi.table.clone()))
            out, aux, new = render(scene, state, *a, **k)
            return out, aux, change(new, old)
        return frame
    return fault


def _slot_word(word, value):
    """The hash table with word ``word`` of every occupied slot set to
    ``value(new_words, old_words)``."""
    def change(new, old):
        table = new.gi.table.clone()
        slots, before = table.view(-1, 4), old.gi.table.view(-1, 4)
        used = slots[:, 0] != 0
        slots[used, word] = value(slots[used, word], before[used, word])
        return dataclasses.replace(new, gi=type(new.gi)(table=table))
    return change


STATE_FAULTS = {
    "view_proj_stale": ("dense-orbit-1080p", "state_words", _state_field(
        lambda new, old: dataclasses.replace(
            new, prev_view_proj=old.prev_view_proj))),
    "frame_index_stuck": ("dense-orbit-1080p", "state_words", _state_field(
        lambda new, old: dataclasses.replace(
            new, frame_index=old.frame_index))),
    "fingerprint_corrupted": ("hash-orbit-1080p", "hash_slots", _state_field(
        _slot_word(0, lambda new, old: new ^ 1))),
    "last_access_stale": ("hash-orbit-1080p", "hash_slots", _state_field(
        _slot_word(2, lambda new, old: old))),
}


@pytest.mark.parametrize("fault", sorted(STATE_FAULTS))
def test_state_fault_is_not_correct(monkeypatch, fault):
    """A field of the state handed on that the reference reads back from
    the program, wrong: the check compares it exactly or by slots."""
    from dust_tpu_torch.render import pipeline

    workload, number, made = STATE_FAULTS[fault]
    monkeypatch.setattr(pipeline, "render_frame", made(pipeline.render_frame))
    out, _run = run_tiny(workload, seed=2**31 + 31)
    assert not out["correct"], out["checks"]
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]


def test_albedo_refresh_skipped_is_not_correct(monkeypatch):
    """The leaf tier writes its edits but leaves the dense GI cache's
    albedo words of the touched leaves stale."""
    from dust_tpu_torch.render import edits

    monkeypatch.setattr(edits, "patch_gi_albedo",
                        lambda table, rows, albedo: table)
    out, _run = run_tiny("dense-edits-1080p", seed=2**31 + 37)
    assert not out["correct"], out["checks"]
    assert out["checks"]["state_words"]["value"] > 0
    assert out["checks"]["scene_words"]["value"] == 0


def test_edit_dropped_is_not_correct(monkeypatch):
    """The leaf tier reports its edits landed but writes none of them."""
    from dust_tpu_torch.render import edits

    monkeypatch.setattr(edits, "apply_leaf_patch",
                        lambda device, *a, **k: device)
    out, _run = run_tiny("dense-edits-1080p", seed=2**31 + 29)
    assert not out["correct"], out["checks"]
    assert out["checks"]["scene_words"]["value"] > 0


def test_unbroken_run_is_correct():
    out, _run = run_tiny("dense-orbit-1080p", seed=2**31 + 23)
    assert out["correct"], out["checks"]
    assert dataclasses.is_dataclass(_run)


# ---------------------------------------------------------------- sharded
# Hooks: each is called with the mesh in every rank before the run.

def image_rows_left_out(mesh):
    """The presented image's gather leaves the last rank's rows out."""
    from dust_tpu_torch import parallel

    gather = parallel.gather_image

    def left_out(mesh, rows, height):
        whole = gather(mesh, rows, height).clone()
        whole[(mesh.size - 1) * mesh.chunk(height):] = 0.0
        return whole
    parallel.gather_image = left_out


def gi_rows_not_handed_on(mesh):
    """The last rank hands on its rows of the dense GI table as it got
    them: its share of the frame's refresh is lost."""
    from dust_tpu_torch.render import pipeline

    render = pipeline.render_frame

    def frame(scene, state, *a, **k):
        old = state.gi.table.clone()
        out, aux, new = render(scene, state, *a, **k)
        if mesh.rank == mesh.size - 1:
            new = dataclasses.replace(new, gi=type(new.gi)(table=old))
        return out, aux, new
    pipeline.render_frame = frame


def _on_rank_one(mesh, act):
    """Rank 1 runs ``act()`` in its fifth frame (the window's third)."""
    from dust_tpu_torch.render import pipeline

    render = pipeline.render_frame
    frames = [0]

    def frame(*a, **k):
        frames[0] += 1
        if mesh.rank == 1 and frames[0] == 5:
            act()
        return render(*a, **k)
    pipeline.render_frame = frame


def rank_raises(mesh):
    def act():
        raise RuntimeError("a planted fault")
    _on_rank_one(mesh, act)


def rank_killed(mesh):
    _on_rank_one(mesh, lambda: os.kill(os.getpid(), signal.SIGKILL))


SHARDED_FAULTS = {"image_rows_left_out": "output_rel",
                  "gi_rows_not_handed_on": "state_rel"}


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_run_is_correct(tmp_path, ranks):
    """A whole sharded run at the tiny size reads 0.0 on every number: at
    128x72 the exposure's bin sum (at most 255 a pixel, 9,216 pixels) is
    below 2^24, so its float32 all-reduce rounds nowhere, and nothing
    else the sharded frame computes differs from the whole frame."""
    out = run_sharded_tiny(sharded_cell(tmp_path, ranks), seed=2**31 + 41,
                           trace=True)["out"]
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values()), out
    assert out["device"]["count"] == ranks
    assert "hdda_launches_per_frame" in {k.split(".")[0]
                                         for k in out["metrics"]}


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("fault", sorted(SHARDED_FAULTS))
def test_sharded_fault_is_not_correct(tmp_path, ranks, fault):
    out = run_sharded_tiny(sharded_cell(tmp_path, ranks), seed=2**31 + 43,
                           hook=fault)["out"]
    assert not out["correct"], out["checks"]
    c = out["checks"][SHARDED_FAULTS[fault]]
    assert c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("fault", ["rank_raises", "rank_killed"])
def test_failed_rank_ends_the_run(tmp_path, fault):
    """A rank that raises, or is killed, in the window ends the run at
    once: every other rank is killed and there is no result, well within
    the collectives' timeout."""
    from benchmark import ranks

    code = {"rank_raises": 1, "rank_killed": -signal.SIGKILL}[fault]
    t = time.monotonic()
    with pytest.raises(ranks.RankFailed, match=f"rank 1 with code {code}"):
        run_sharded_tiny(sharded_cell(tmp_path, 4), seed=2**31 + 47,
                         seconds=30.0, hook=fault)
    assert time.monotonic() - t < 120.0
