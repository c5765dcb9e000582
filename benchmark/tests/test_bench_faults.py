"""The comparison that decides `correct` fails what it must, at a tiny size
on the CPU: each control (one stated precision a step lower) put in the
port's place through the harness's own check, and a run with the timed
path broken underneath (the decode step leaving its state unchanged, half
of the batch left out, a token altered where it is produced).  The cells'
own limits and readings on the card are in PERF.md.  At this size the
port's tokens, on the kernels' plain versions, are the stated-precision
reference's first choice at every position (gap 0 on every seed tried), so
the comparison is exact: limit 0.  The controls need many tokens to move
one here (the tiny models are far from the full-size ones' near-chaos; the
bf16 ones moved none in 60 tokens on some seeds), so their runs are 3 s
and judge every finished request."""

import os
import time

import pytest

from benchmark.harness.bench import Bench
from benchmark.harness.runner import run_cell

from .conftest import DATA

# the cell's traffic kind at each family's tiny size (the OPT path has no
# cell on the card: PERF.md section 7)
CELLS = {"llama": ("mistral-7b.batch", "tiny-llama.json"),
         "opt": ("mistral-7b.batch", "tiny-opt.json")}
CONTROLS = [("llama", "linear_input.int4"), ("llama", "kv.int4"), ("llama", "hidden.bf16"),
            ("opt", "linear_input.bf16"), ("opt", "kv.int4"), ("opt", "hidden.bf16")]


def _cell(family, sample_requests=8):
    name, cfg = CELLS[family]
    cell = Bench().cell(name, os.path.join(DATA, cfg), os.path.join(DATA, "tiny_closed.json"))
    cell.limits = {"max_logit_gap": {"limit": 0.0}, "mean_logit_gap": {"limit": 0.0},
                   "sample_requests": sample_requests}
    return cell


def _run(cell, seed, hook=None, seconds=1.5, control=None):
    return run_cell(cell, seed, seconds, False, "cpu", time.perf_counter(), system_hook=hook,
                    control=control)[0]


@pytest.mark.parametrize("family,control", CONTROLS)
@pytest.mark.parametrize("seed", [2**40 + 1, 2**40 + 2, 2**40 + 3])
def test_control_in_the_ports_place_is_not_correct(family, control, seed):
    res = _run(_cell(family, sample_requests=64), seed, seconds=3.0, control=control)
    assert not res["correct"], res["check"]
    assert res["check"]["mean_logit_gap"]["value"] > 0


def _unchanged_state(system, monkeypatch):
    from pb_llm_tpu_torch.models import llama, opt

    real = llama.cache_update

    def skip_decode_writes(cache, k, v, pos):
        return cache if k.shape[1] == 1 else real(cache, k, v, pos)

    monkeypatch.setattr(llama, "cache_update", skip_decode_writes)
    monkeypatch.setattr(opt, "cache_update", skip_decode_writes)


def _half_batch(system, monkeypatch):
    eng = system.engine
    real = eng._step_logits

    def half():
        logits = real().clone()
        n = logits.shape[0] // 2
        logits[n:] = logits[:n].mean(dim=0)  # rows left out; the mean of the rest in their place
        return logits

    eng._step_logits = half


def _token_altered(system, monkeypatch):
    eng = system.engine
    real = eng.decode_step
    steps = [0]

    def altered():
        out = real()
        steps[0] += 1
        if steps[0] % 3 == 0:  # every third step's tokens, in every slot
            for slot in out:
                out[slot] = (out[slot] + 1) % system.cell.config["vocab_size"]
                eng.last_token[slot] = out[slot]
        return out

    eng.decode_step = altered


@pytest.mark.parametrize("family", ["llama", "opt"])
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _token_altered])
def test_a_broken_timed_path_is_not_correct(family, fault, monkeypatch):
    cell = _cell(family)
    res = _run(cell, 2**41 + 7, hook=lambda system: fault(system, monkeypatch))
    assert not res["correct"], res["check"]
    assert res["check"]["max_logit_gap"]["value"] > 0  # the gap, not the bookkeeping


@pytest.mark.parametrize("seed", [2**40 + 1, 2**40 + 2, 2**40 + 3, 2**41 + 7])
def test_a_sound_run_of_each_family_is_correct(seed):
    for family in CELLS:
        res = _run(_cell(family, sample_requests=64), seed, seconds=3.0)
        assert res["correct"], (family, res["check"])
