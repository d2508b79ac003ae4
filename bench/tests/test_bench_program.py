"""The metrics that read the program's own spans and counters
(``bench/program.py``), on the CPU at the tiny sizes of ``conftest.py``:
the new readers read, the older readers read as they did with the
recorder disarmed, the decode dispatch's parts add up to the harness's
dispatch time, the program's counts reproduce the harness's slot
occupancy and prefill row use on the same run, and a program without the
recorder leaves the new metrics out."""
import json
import math

import pytest

from conftest import tiny

from bench import harness, program, yardstick

SEED = 2 ** 31 + 4242
NEW = {"resnet18.b128": ["cnn.forward_host_ms_per_batch"],
       "qwen3-4b.doc4k": ["lm.decode_enqueue_ms_per_step",
                          "lm.decode_wait_ms_per_step"]}
# the older metrics an untraced CPU run reads (the others need the trace)
HOST = {"resnet18.b128": ["cnn.mfu"],
        "qwen3-4b.doc4k": ["lm.mfu", "lm.decode_ms_per_step",
                           "lm.prefill_row_use", "lm.slot_occupancy",
                           "lm.queue_ms_p50"]}
# windows long enough for a few decode dispatches on a busy host
SECONDS = {"resnet18.b128": 1.5, "qwen3-4b.doc4k": 3.0}


def untraced(cell, seconds, spy=None):
    """One tiny untraced run on the CPU: its per-layer line, and with
    ``spy`` the context the readers were given."""
    lines, seen = [], {}
    if spy is not None:
        readers = cell.readers

        def spied():
            out = readers()
            read = out[spy].read

            def wrapped(ctx):
                seen["ctx"] = ctx
                return read(ctx)
            out[spy].read = wrapped
            return out
        cell.readers = spied
    res = harness.run(cell, SEED, seconds, False, device="cpu",
                      log=lines.append)
    assert res["correct"], res["checks"]
    line = next(l for l in lines if l.startswith("untraced per-layer: "))
    return json.loads(line.split(": ", 1)[1]), seen.get("ctx")


@pytest.mark.parametrize("workload", sorted(NEW))
def test_the_new_readers_read(workload):
    got, _ = untraced(tiny(workload), SECONDS[workload])
    for name in NEW[workload]:
        assert name in got and got[name] > 0, (name, got)


@pytest.mark.parametrize("workload", sorted(NEW))
def test_older_readers_read_as_without_the_recorder(workload):
    assert program.RECORDER is not None
    program.RECORDER.__exit__(None, None, None)
    try:
        plain, _ = untraced(tiny(workload), SECONDS[workload])
    finally:
        program.RECORDER.__enter__()
    first = len(program.RECORDER.records)
    armed, ctx = untraced(tiny(workload), SECONDS[workload],
                          spy=NEW[workload][0])
    assert not set(NEW[workload]) & set(plain)
    for got in (plain, armed):
        assert [n for n in got if n not in NEW[workload]] == HOST[workload]
        assert all(math.isfinite(got[n]) and got[n] >= 0
                   for n in HOST[workload])
    # the functions the harness wraps run as before, the program's spans
    # inside them: one engine.generate in each wrapped generate call, one
    # cnn.forward in each wrapped forward
    name, label = (("engine.generate", "bench.generate")
                   if workload.startswith("qwen")
                   else ("cnn.forward", None))
    ours = [r for r in program.RECORDER.records[first:] if r.name == name]
    assert ours
    for (t0, t1), r in zip(ctx["times"].get(label, []), ours):
        assert t0 <= r.start_ns / 1e9 <= r.end_ns / 1e9 <= t1
    if label is not None:
        assert len(ctx["times"][label]) == len(ours)


def test_decode_parts_add_up_to_the_dispatch():
    got, _ = untraced(tiny("qwen3-4b.doc4k"), SECONDS["qwen3-4b.doc4k"])
    parts = got["lm.decode_enqueue_ms_per_step"] + \
        got["lm.decode_wait_ms_per_step"]
    assert 0.8 * got["lm.decode_ms_per_step"] <= parts \
        <= got["lm.decode_ms_per_step"]


def test_program_counts_reproduce_the_harness_counts():
    rec = program.RECORDER
    first = len(rec.records)
    before = dict(rec.counters)
    got, ctx = untraced(tiny("qwen3-4b.doc4k"), SECONDS["qwen3-4b.doc4k"],
                        spy="lm.slot_occupancy")
    records = rec.records[first:]
    delta = lambda name: rec.counter(name) - before.get((name, ()), 0)
    # over the whole run the counters equal the spans' attributes
    gens = [r for r in records if r.name == "engine.generate"]
    prefills = [r for r in records if r.name == "engine.prefill"]
    assert delta("sched.decode_steps") == sum(g.attrs["steps"]
                                              for g in gens)
    assert delta("sched.occupied_slot_steps") == sum(
        g.attrs["steps"] * len(g.attrs["slots"]) for g in gens)
    assert delta("engine.prefill_rows") == sum(p.attrs["rows"]
                                               for p in prefills)
    assert delta("engine.prompt_tokens") == sum(p.attrs["prompt"]
                                                for p in prefills)
    # in the window, the same counts as the harness's, up to one dispatch
    # and one prefill at the window's close (the harness counts a token
    # or a first token by its callback, the program by its dispatch)
    host, slots = ctx["window"]["host"], ctx["window"]["slots"]
    held = lambda rs: [r for r in rs if host.holds(r.end_ns / 1e9)]
    gens, prefills = held(gens), held(prefills)
    steps = sum(g.attrs["steps"] for g in gens)
    occupancy = yardstick.share(sum(g.attrs["steps"] * len(g.attrs["slots"])
                                    for g in gens), steps * slots)
    assert steps >= 3 and len(prefills) >= 3
    assert occupancy == pytest.approx(got["lm.slot_occupancy"],
                                      abs=100.0 / (steps - 1))
    row_use = yardstick.share(sum(p.attrs["prompt"] for p in prefills),
                              sum(p.attrs["rows"] for p in prefills))
    assert row_use == pytest.approx(got["lm.prefill_row_use"],
                                    abs=100.0 / (len(prefills) - 1))


def test_without_the_recorder_the_new_metrics_are_left_out(monkeypatch):
    monkeypatch.setattr(program, "RECORDER", None)
    got, _ = untraced(tiny("resnet18.b128"), SECONDS["resnet18.b128"])
    assert "cnn.forward_host_ms_per_batch" not in got
    ctx = {"window": {"host": yardstick.HostWindow(0.0, 1e12)}}
    for names in NEW.values():
        for name in names:
            assert harness.load_reader(name).read(ctx) is None
