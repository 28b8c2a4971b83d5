"""A run with the timed path broken underneath comes out as not correct:
the rest of the run is the harness's own (the look for a card skipped,
a tiny size on the CPU). One test for each fault the cells can have; a
cell on one card has no exchange between chips to leave out."""

import dataclasses

import pytest
import torch

from conftest import run_tiny


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
