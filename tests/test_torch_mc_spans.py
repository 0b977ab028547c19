"""The Monte-Carlo renderer's spans and counters (ops/flagship.py): one
``c2rt.mc_pass`` per pass (a DoF sample, or a tap of a frame without DoF,
both eyes of a stereo pair in one), one ``c2rt.raygen`` inside it before
its first K1 call, and one ``c2rt.env`` around each part of
``combine_outputs`` that reads the cubemap, counted by ``flagship.mc_passes``
and ``flagship.env_gathers``.  Small frames of the stand-in on the CPU,
where ``round0`` runs its plain version; a frame under the profiler is the
frame without it, bit for bit."""

import dataclasses
import functools

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chess2rt_tpu_torch.models import types as TT
from chess2rt_tpu_torch.models.packed import pack_scene
from chess2rt_tpu_torch.ops import flagship, prng
from chess2rt_tpu_torch.render.pipeline import render_frame
from chess2rt_tpu_torch.scenes import flagship_standin

torch.set_num_threads(2)

W, H, SAMPLES = 32, 24, 2
# each case: the stand-in's builder arguments, the settings it renders
# under, and its passes (five AA taps, each of SAMPLES DoF samples or one)
CASES = {
    "dof_env": ({"dof": True, "env": True}, {}, 5 * SAMPLES),
    "dof_env_adaptive": ({"dof": True, "env": True}, {"aa_adaptive": True}, 5 * SAMPLES),
    "dof": ({"dof": True}, {}, 5 * SAMPLES),
    "stereo": ({"stereo": True}, {}, 5),
    "stereo_dof_env": ({"stereo": True, "dof": True, "env": True}, {}, 5 * SAMPLES),
    "whitted_env": ({"env": True}, {}, 0),
}
MC_NAMES = ("c2rt.mc_pass", "c2rt.raygen", "c2rt.env")


def _counters():
    return flagship.mc_passes, flagship.env_gathers


@functools.lru_cache(maxsize=None)
def _runs(case):
    """The case's frame without a profiler and under one: (frame off, frame
    on, the c2rt.* events as (name, start, end), (passes, env gathers) off,
    the same on)."""
    args, settings, _ = CASES[case]
    packed, static = pack_scene(flagship_standin(TT, W, H, samples=SAMPLES, **args), device="cpu")
    static = dataclasses.replace(static, **settings)
    key = prng.PRNGKey(2024)

    def frame():
        before = _counters()
        with torch.no_grad():
            img = render_frame(packed, static, key)
        return img, tuple(a - b for a, b in zip(_counters(), before))

    off, counted_off = frame()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on, counted_on = frame()
    events = sorted((e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("c2rt."))
    return off, on, events, counted_off, counted_on


def _spans(events, name):
    return [(s, t) for n, s, t in events if n == name]


def _inside(inner, outer):
    return [i for i in inner if any(o[0] <= i[0] and i[1] <= o[1] for o in outer)]


@pytest.mark.parametrize("case", list(CASES))
def test_a_frame_counts_and_spans_its_passes(case):
    off, on, events, counted_off, counted_on = _runs(case)
    passes = CASES[case][2]
    assert torch.equal(off, on)
    assert counted_off == counted_on
    assert counted_on[0] == passes
    pass_spans, raygen = _spans(events, "c2rt.mc_pass"), _spans(events, "c2rt.raygen")
    assert len(pass_spans) == len(raygen) == passes
    assert len(_inside(raygen, pass_spans)) == passes
    # a pass's ray-gen ends before its first K1 call starts
    k1 = _spans(events, "c2rt.k1")
    for (s, t), (rs, rt) in zip(pass_spans, raygen):
        first = min(a for a, b in k1 if s <= a and b <= t)
        assert s <= rs and rt <= first
        # the four draws of a DoF sample (jitter, disc) are ray-gen's
        draws = _inside(_spans(events, "c2rt.draw"), [(s, t)])
        assert len(draws) == (4 if CASES[case][0].get("dof") else 0)
        assert len(_inside(draws, [(rs, rt)])) == len(draws)


@pytest.mark.parametrize("case", list(CASES))
def test_the_environment_is_spanned_where_it_is_read(case):
    _, _, events, _, counted = _runs(case)
    env = _spans(events, "c2rt.env")
    assert len(env) == counted[1]
    if CASES[case][0].get("env"):
        assert env
        # the merged gather (the stand-in has bitmaps) stays nested in it
        assert len(_inside(_spans(events, "c2rt.gather"), env)) >= len(env)
    else:
        assert not env


def test_a_stereo_pass_traces_both_eyes():
    _, _, events, _, _ = _runs("stereo")
    taps = _spans(events, "c2rt.tap")
    for p in _spans(events, "c2rt.mc_pass"):
        assert len(_inside(taps, [p])) == 2


def test_a_deterministic_frame_has_no_monte_carlo_span():
    """The Whitted frame without an environment (the 1080p cell's kind)
    enters none of the new branches."""
    packed, static = pack_scene(flagship_standin(TT, W, H), device="cpu")
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            render_frame(packed, static)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert _counters() == before
    assert "c2rt.tap" in names and not names & set(MC_NAMES)
