"""The plain reference agrees with the port at a tiny size: its own
dequantization with the port's, its f32 forward with the port's forward
(the port's plain CPU path, no cache), for both families."""

import json
import os

import pytest
import torch

from benchmark import reference
from benchmark.harness.check import gap_numbers
from benchmark.reference import dequant
from benchmark.weights import pbw

from .conftest import DATA


@pytest.mark.parametrize("kw", [dict(), dict(col_tile=64), dict(side_bits=4),
                                dict(ic_shards=2, bias=True)])
def test_dense_v2_is_the_ports(kw):
    from pb_llm_tpu_torch.core.pbw import PackedLinearV2, dequantize_v2

    p = pbw.random_v2(256, 192, torch.Generator().manual_seed(9), **kw)
    want = dequantize_v2(PackedLinearV2(**p))
    # W_off + W_cen: one more f32 rounding than the port's single expression
    assert torch.allclose(dequant.dense_v2(p), want, rtol=0, atol=2e-7 * want.abs().max())


@pytest.mark.parametrize("kw", [dict(), dict(groupsize=64), dict(sidecar_bits=4, bias=True)])
def test_dense_v1_is_the_ports(kw):
    from pb_llm_tpu_torch.core.pbw import PackedLinear, dequantize

    p = pbw.random_v1(256, 96, torch.Generator().manual_seed(10), **kw)
    assert torch.equal(dequant.dense_v1(p), dequantize(PackedLinear(**p)))


def _port(name):
    import importlib

    cfg = json.load(open(os.path.join(DATA, name)))
    fam = importlib.import_module(f"benchmark.families.{cfg['family']}")
    return cfg, fam, fam.program_params(cfg, SEED, torch.device("cpu"))


SEED = 2**36 + 5
INT8 = dict(backend="pallas_interpret", decode_dot="int8", prefill="int8")


@pytest.mark.parametrize("name,kernels,prec", [
    ("tiny-llama.json", dict(backend="xla"), reference.EXACT),
    ("tiny-llama.json", INT8, reference.Precision(linear_input="int8")),  # the int8 arms' rounding
    ("tiny-opt.json", dict(backend="xla"), reference.EXACT),
    ("tiny-opt.json", INT8, reference.EXACT)])                 # v1 carries x exactly
def test_forward_is_the_ports(name, kernels, prec):
    import importlib

    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig, use_kernels

    cfg, fam, params = _port(name)
    ids = torch.randint(0, cfg["vocab_size"], (1, 40), generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), use_kernels(KernelConfig(**kernels)):
        want, _ = fam.FAMILY.forward(params, ids, fam.program_config(cfg))
    ref = importlib.import_module(f"benchmark.reference.{cfg['family']}")
    arms, outer = reference.final_hidden(cfg, SEED, "cpu", [ids[0].tolist()], (prec,))
    got = ref.head(cfg, outer, arms[0][0], prec)
    assert (got - want[0]).abs().max() <= 2e-5 * want.abs().max()


@pytest.mark.parametrize("name", ["tiny-llama.json", "tiny-opt.json"])
def test_gaps_of_streams(name):
    """The stated-precision reference's own greedy stream lies 0 below its
    best, and with its sums in another order all but 0; the int4 controls
    read above 0; an id off the vocabulary reads infinite."""
    import importlib

    cfg, fam, _ = _port(name)
    ref = importlib.import_module(f"benchmark.reference.{cfg['family']}")
    seq = torch.randint(0, cfg["vocab_size"], (30,), generator=torch.Generator().manual_seed(4))
    seq = seq.tolist()
    for _ in range(10):
        arms, outer = reference.final_hidden(cfg, SEED, "cpu", [seq],
                                             (reference.stated_precision(cfg),))
        seq.append(int(ref.head(cfg, outer, arms[0][0][-1:], reference.stated_precision(cfg))
                       .argmax()))
    ctls = reference.controls(cfg)
    gaps, (same, order, *ctl) = reference.forward_gaps(
        cfg, SEED, "cpu", [(seq[:30], seq[30:])],
        (reference.stated_precision(cfg), reference.stated_precision(cfg, reorder=True),
         *ctls.values()))
    assert widest(gaps) == 0 and widest(same) == 0 and widest(order) < 1e-3
    assert sorted(ctls) == sorted(CONTROLS[cfg["family"]])
    read = dict(zip(ctls, map(widest, ctl)))
    # int4 moves tokens within 10; bf16 needs hundreds here (test_bench_faults)
    assert all(v > 0 if k.endswith("int4") else 0 <= v < float("inf") for k, v in read.items()), read
    bad = seq[30:-1] + [cfg["vocab_size"]]
    assert widest(reference.forward_gaps(cfg, SEED, "cpu", [(seq[:30], bad)])[0]) == \
        float("inf")


CONTROLS = {"llama": ["linear_input.int4", "kv.int4", "hidden.bf16"],
            "opt": ["linear_input.bf16", "kv.int4", "hidden.bf16"]}


def widest(gaps) -> float:
    return gap_numbers(gaps)["max_logit_gap"]
