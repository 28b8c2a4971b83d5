"""The slice by the program's spans (``stages.stage_tables``) on
synthetic events: each device activity under the stage open where its
launching call began, matched by correlation id, a pass's span inside a
stage counting for the stage; activity launched outside every stage or
by no call found; blocking calls and idle gaps by stage."""

import pytest

from benchmark import stages

US = 1000  # ns

# One frame: dust.frame [0, 100) us holding the stages, two trace passes.
SPANS = [(0, 100 * US, "dust.frame"),
         (1 * US, 20 * US, "dust.primary"),
         (2 * US, 5 * US, "dust.hdda.precise"),
         (20 * US, 40 * US, "dust.sun"),
         (40 * US, 70 * US, "dust.refresh"),
         (50 * US, 60 * US, "dust.hdda.rough"),
         (70 * US, 99 * US, "dust.post")]
# (launching call's start, correlation id)
LAUNCHES = [(3 * US, 11),          # the precise pass, in dust.primary
            (10 * US, 12),         # dust.primary
            (55 * US, 13),         # dust.hdda.rough inside dust.refresh
            (99.5 * US, 14),       # in dust.frame, after dust.post
            (120 * US, 15),        # the harness, outside any span
            (20 * US, 16)]         # at the start of dust.sun
# (correlation id, ns on the card); 99 has no launching call in the trace
ACTIVITIES = [(11, 4 * US), (12, 1 * US), (13, 8 * US), (14, 2 * US),
              (15, 3 * US), (16, 5 * US), (99, 7 * US)]
SYNCS = [30 * US, 65 * US, 66 * US, 110 * US]
GAPS = [(0, 2 * US),               # before the first stage
        (21 * US, 24 * US),        # between ops in dust.sun
        (69 * US, 75 * US),        # opens in dust.refresh, ends in post
        (100 * US, 130 * US)]      # after the frame


@pytest.fixture(scope="module")
def tables():
    return dict(zip(("host", "device", "syncs", "idle"),
                    stages.stage_tables(SPANS, LAUNCHES, ACTIVITIES, SYNCS,
                                          GAPS)))


def _close(got: dict, want: dict):
    assert set(got) == set(want), got
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-12), (k, got)


def test_span_host_seconds(tables):
    _close(tables["host"], {
        "dust.frame": 100e-6, "dust.primary": 19e-6,
        "dust.hdda.precise": 3e-6, "dust.sun": 20e-6, "dust.refresh": 30e-6,
        "dust.hdda.rough": 10e-6, "dust.post": 29e-6})


def test_device_seconds_by_launching_stage(tables):
    _close(tables["device"], {
        "dust.primary": 5e-6, "dust.sun": 5e-6, "dust.refresh": 8e-6,
        stages.NO_STAGE: 5e-6, stages.NO_LAUNCH: 7e-6})
    assert sum(tables["device"].values()) == pytest.approx(
        sum(length for _, length in ACTIVITIES) * 1e-9)


def test_syncs_and_idle_by_stage(tables):
    assert tables["syncs"] == {"dust.sun": 1, "dust.refresh": 2,
                               stages.NO_STAGE: 1}
    _close(tables["idle"], {stages.NO_STAGE: 32e-6, "dust.sun": 3e-6,
                            "dust.refresh": 6e-6})


def test_spans_outside_the_stages_are_not_stages():
    """Without stage spans every activity found is outside any stage."""
    frame_only = [sp for sp in SPANS if sp[2] not in stages.STAGES]
    _host, device, syncs, idle = stages.stage_tables(
        frame_only, LAUNCHES, ACTIVITIES, SYNCS, GAPS)
    assert set(device) == {stages.NO_STAGE, stages.NO_LAUNCH}
    assert set(syncs) == set(idle) == {stages.NO_STAGE}


def test_program_without_spans():
    """A program that opens no span: no span's host time, and everything
    outside any stage, so the stage metrics read nothing."""
    host, device, syncs, idle = stages.stage_tables(
        [], LAUNCHES, ACTIVITIES, SYNCS, GAPS)
    assert host == {}
    assert set(device) == {stages.NO_STAGE, stages.NO_LAUNCH}
    assert set(syncs) == set(idle) == {stages.NO_STAGE}



def test_traced_slice_on_the_cpu():
    """A tiny dense cell's slice traced on the CPU: the frame's span, its
    five stages and the trace passes' spans, each stage inside the frame;
    no device activity, so the whole slice is one idle gap."""
    import torch

    from conftest import load_cell, tiny

    cell = tiny(load_cell("dense-orbit-1080p"))
    sl, st = stages.trace_slice(cell, 2**31 + 41, torch.device("cpu"))
    assert st.frames == sl.frames == cell.traffic["trace_frames"]
    host = st.span_host_s
    assert set(stages.STAGES) | {"dust.frame"} <= set(host)
    assert {n for n in host if n.startswith("dust.hdda.")} == {
        "dust.hdda.precise", "dust.hdda.ao_fg", "dust.hdda.ao_threshold",
        "dust.hdda.rough"}
    assert sum(host[s] for s in stages.STAGES) <= host["dust.frame"] \
        <= sl.wall_s
    assert st.stage_device_s == {} and st.stage_syncs == {}
    assert st.stage_idle_s.keys() == {stages.NO_STAGE}
    assert st.stage_idle_s[stages.NO_STAGE] == pytest.approx(sl.wall_s)
    table = st.per_frame()
    assert table["span_host_ms"]["dust.frame"] == pytest.approx(
        1e3 * host["dust.frame"] / st.frames)
