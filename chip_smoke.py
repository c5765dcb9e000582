#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pb_llm_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py            # the whole run, one card
    python3 chip_smoke.py --profile  # also trace three decode steps

Phases (they run in order, but 12a, 12b and then the producers 5 and 8 run
last: the producers pin the exact prefill for the rest of the process, as
run_ptq does); any failure raises and the exit code is not 0:

1. set-up: the card's name and power limit (nvidia-smi), the kernels built
   from `pb_llm_tpu_torch/csrc/` in parallel (one nvcc each), TF32 off;
2. each kernel against its plain PyTorch version at the main paths' shapes,
   with its time (CUDA events, L2 flushed before every launch), the plain
   version's time, one PyTorch library call's time as a yardstick where one
   call computes the same function, and the least time the card could take
   (`bound_ms`): the int8 matmul's arms (dp4a, the tensor cores, and up to
   16 rows their K-split decode arm "split", bit for bit, at 1-1024 rows:
   the crossover M_TC) and decode attention (serving; its int8, bf16 and
   q8 cache arms, each in the "split" and "slot" kernel arms), the
   binary-part dequant, the
   exact f32 matmul's three arms (f32 CUDA cores, bf16 tensor cores with x in
   three terms; crossover F32_TC; below it "split", the dma kernel's device
   code, flat and stacked, at 1-31 rows on llama-7b's shapes and a fused
   q|k|v layer) and flash attention's two arms (bf16
   tensor cores, q, k, p, v in bf16 terms, also dots_bf16; f32 CUDA cores;
   the producers' eval windows),
   paged attention (the paged pool: decode, speculative verify, chunk
   continuation, GQA; int8, f32 and bf16 pages, every page past a slot's
   live keys NaN; decode on the "split" arm in both of its loads, windows
   on the tensor-core arm, each timed beside the CUDA-core arm, and "split"
   on the verify windows of t·G <= 8 rows), the
   PBW-v1 planar and select matmuls (OPT-1.3B's and llama-7b's MLP
   shapes; the planar kernel's two arms at 1-255 rows, bf16 tensor cores
   with C, M, V exact and x in three bf16 terms in both column tiles, and
   f32 CUDA cores, with select "tc" on the same x; the select kernel's two
   arms, bf16 tensor cores with x and w in bf16 terms and f32 CUDA cores,
   and their crossover SELECT_TC), and the int8 path's x preparation, bit
   for bit;
3. the same 2-layer full-width llama-7b engine on the card (kernels) and on
   the CPU (the kernels' plain versions): prefill logits, teacher-forced
   NLL and 8 greedy tokens; once on the int8 arms, once on the exact arms
   (`serve --decode_dot f32 --prefill_kernel hybrid`), whose f32 matmul
   launches are counted;
4. end to end, serving: a 32-layer full-width random PBW-v2 llama-7b
   serving 16 requests through `ContinuousBatcher`, twice on one engine:
   under `step_graph.eager()` (the decode step op by op), then graphed (the
   default: one CUDA graph replayed a step); the launch counters are zeroed
   just before each pass and read just after, and must match the forwards
   run (the int8 matmul by arm, by each forward's rows), and the prefill
   forwards' synchronised wall time is summed (`prefill_ms_total`);
5. end to end, the producer: a 2-layer full-width llama-7b calibrated by
   GPTQ-PB into PBW v2 on synthetic text, then its windowed perplexity under
   the exact hybrid prefill, with the kernels and with their plain versions
   (which must agree); the launch counters are zeroed just before and read
   just after.  One linear is also solved on the card and on the CPU;
6a. paged serving invariants on a 2-layer full-width llama-7b: the int8
   paged engine on the card against the CPU (phase 3's bounds), then, on
   the exact arms, paged equals strip, prefix cache on equals off, chunked
   equals one-shot, speculative equals plain, a preempting pool equals an
   ample one, a self-draft model accepts >= 95% (greedy streams under the
   margin rule);
6b. end to end, paged serving: the 32-layer model of phase 4 behind a paged
   int8 pool with the prefix cache and chunked prefill, 16 requests twice
   (plain decode, then spec_gamma 4); the launch counters are zeroed just
   before each pass and read just after, and must match the forwards run;
7a. a 2-layer full-width OPT-1.3B with random PBW-v1 planes (groups of
   128) and random biases on the card (kernels) and on the CPU (plain
   versions): prefill logits, teacher-forced NLL, 8 greedy tokens;
7b. end to end, PBW-v1 serving: the 24-layer full-width OPT-1.3B through
   `ContinuousBatcher`, int8 strips, phase 4's request mix; planar and
   select (by arm) and decode-attention launches must match the forwards
   run, by rows; the prefill forwards' synchronised time (`prefill_ms_total`), and
   the mix served again with the select arm forced to "cores" and back;
8. end to end, the PBW-v1 producer: a 2-layer OPT-1.3B-width model
   calibrated by GPTQ-PB (element masks, groups of 128) into PBW v1, then
   its windowed perplexity with the kernels and with their plain versions;
9a. scanned layers, fused linears and the pair / dma decode arms on a
   2-layer full-width llama-7b: on the exact arms, scan equals unrolled
   (strips and pages, the stacked f32 kernel) and fused equals unfused
   (greedy streams under the margin rule); the pair and dma arms, and
   scan_layers on the exact arms, on the card against the CPU's plain
   versions (phase 3's bounds);
9b. end to end on the 32-layer model of phase 4, int8 strips, phase 4's
   request mix, three passes: scan_layers (the stacked int8 kernel),
   fuse_linears + decode_dot pair, decode_dot dma (its arm "split" and that
   arm's x preparation); every launch counter must match the forwards run,
   by rows;
10a. the bf16 and q8 KV arms on a 2-layer full-width llama-7b, card against
   CPU under phase 3's bounds, in three engines: int8 strips with
   decode_attention "pallas_q8", bf16 strips, a bf16 paged pool with the
   prefix cache (the second prompt hits two cached pages);
10b. end to end through HTTP: the 32-layer model of phase 4 behind
   `serve_http` on 127.0.0.1, phase 4's 16 requests from 8 client threads
   (every other one streamed as NDJSON), once for each engine of 10a (the
   pages with prefill_chunk 256); every request must retire with its
   tokens, a stream must equal its output_ids, /health and /stats must
   answer, and every launch counter must match the forwards run;
11a. the graphed decode step against `step_graph.eager()` on a 2-layer
   full-width llama-7b, in eight engines (int8 strips; scan_layers;
   fuse_linears + pair; dma; pallas_q8; bf16 strips; int8 and bf16 pages
   with the prefix cache), and on 7a's 2-layer OPT-1.3B (planar "tc"): 18
   decode steps with slots admitted and released between them, equal
   greedy tokens, bitwise-equal logits, equal launches;
11b. paged windows on the tensor cores, card against CPU on 2 full-width
   layers over int8 and bf16 pages with prefill_chunk 64 and the prefix
   cache: on the exact matmul arms greedy tokens equal; on the int8 arms
   the card teacher-forced on the CPU's tokens within phase 10a's bound at
   every step, and each window arm's greedy stream logged where it parts;
12a. an HF checkpoint directory (llama-7b's config cut to 2 layers, random
   dense fp16 weights, `pytorch_model-*.bin` shards of at most 400 MB written
   with torch alone) on the card against the CPU: `hf_import.from_pretrained`
   reads every weight bit for bit; `cli.convert` on the card writes the PBW
   v2 artifact that `rtn_pack_fn` gives in memory; the artifact served on
   the card (int8 arms) against the CPU under phase 3's bounds, launches by
   arm matched to the forwards; streamed GPTQ-PB equals the resident
   pipeline bit for bit with one layer resident;
12b. end to end from a checkpoint: the same config cut to 8 layers (fp16
   shards of at most 1 GB), `python -m pb_llm_tpu_torch.cli.convert` as a
   subprocess, then `from_pretrained` + `load_pbw` + `install_pbw` serving
   phase 4's 16 requests, graphed, every launch counter matched to the
   forwards run; its conversion and serving times.

Phases 6b, 7b, 9b and 10b serve graphed: the default on the card.

Phase 2 also holds the pair kernel's three arms ("mma", and the wgmma
"split" and "tc" arms: crossover PAIR_TC), the dma kernel's two arms
("split", the bf16 tensor cores with a K split in a cluster, and "cores"
at 1-255 rows, with the split arm's x preparation) and the stacked int8 /
f32 kernels (phase 9's paths) at llama-7b's shapes, each with its
operands' preparation time where an arm has its own layout.  The graphed
9b dma pass and 7b by arm, in turns: scripts/torch_v1_dma_arm_ab.py.

The last two lines are the `kernels` JSON line and
`{"ok": true, "device": {...}}`.  A row of the `kernels` line counts its own
arm's launches (each arm's beside, as arm_launches); a row marked
"yardstick" is an arm kept to time the path's arm against and may count 0,
every other row must have launched.  Without CUDA it exits 1 before any
phase.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores

DEV = "cuda"
MATMUL_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
MATMUL_MS = (8, 512)                 # decode (8 slots) and batched prefill (4 x 128)
INT8_MS = (1, 8, 15, 16, 32, 64, 128, 256, 512, 1024)  # the int8 arms' crossover rows, prefill
ATTN_SHAPE = (8, 2048, 32, 32, 128)  # B, S, Hq, Hkv, D: 8 slots of max_seq 2048
ATTN_MAX_LEN = 512
ATTN_ARMS = ("int8", "bf16", "q8")  # decode attention's arms: int8 strips, bf16 strips, int8 q
HEADLINE_SHAPE = (8, 4096, 11008)  # (m, ic, oc) of the kernels line: the MLP at decode
PREFILL_SHAPE = (512, 4096, 11008)  # and at prefill: the int8 matmul's tensor-core arm
MATMUL_TOL = 1e-6     # of max|y|: int32 dots are exact, the epilogue rounds as the plain version
ATTN_RTOL, ATTN_ATOL = 1e-4, 1e-5  # online softmax sums in another order than the plain version
# GPU vs CPU engine on the same int8 arms: the f32 sums (rms_norm, row sums,
# lm_head) run in another order on each device, so now and then one element
# of x lands on the other side of an int8 rounding step; a salient weight
# then moves its output by sx·hs·|code-128|, up to ~0.5·absmax/127, and two
# layers carry that to the logits.  Measured on an H100: 2.0e-2 of max|logit|,
# with equal greedy tokens and the NLL within 7e-4.
LOGIT_TOL = 5e-2      # of max|logit|
NLL_RTOL = 2e-3
# The exact arms round nothing to int8 in the matmuls; only the int8 KV
# cache (the serving default on the card) rounds k and v per row.  Measured
# on an H100: 7.4e-4 of max|logit|, so their bound lies between that and
# the int8 arms' 2.0e-2.
LOGIT_TOL_EXACT = 5e-3  # of max|logit|
DEQUANT_DTYPES = (torch.float32, torch.bfloat16)
# (m, col_tile): decode, global selection; prefill row-grouped and global
F32_CASES = ((8, 0), (512, 256), (512, 0))
F32_CROSS_MS = (8, 16, 32, 64, 128, 256, 512)  # the f32 arms' crossover rows (global selection)
F32_SPLIT_MS = (1, 8, 15, 31)  # the f32 arms' decode rows: below F32_TC, the "split" arm
F32_RTOL, F32_ATOL = 1e-4, 1e-4    # the JAX package's bound for its f32 kernel
FLASH_CASES = ((4, 2048, 32, 128, True),   # B, T, H, D, causal: 4 eval windows of llama-7b
               (1, 2000, 32, 128, True),   # T not a multiple of the 64-row tile
               (1, 2048, 32, 128, False))
FLASH_RTOL, FLASH_ATOL = 1e-4, 1e-4
FLASH_BF16_TOL = 1e-2  # dots_bf16: p rounds to bf16 against the running max (tests' bound)
PAGED_POOL = (1024, 16, 128)  # pages (+ the trash page), page size, table width (max_seq 2048)
PAGED_CASES = (  # name, B, t, Hq, Hkv, D, pages, largest base
    ("decode_int8", 8, 1, 32, 32, 128, "int8", 511),     # 8 slots, lengths up to 512
    ("decode_f32", 8, 1, 32, 32, 128, "f32", 511),
    ("verify_t5_int8", 8, 5, 32, 32, 128, "int8", 507),  # spec_gamma 4
    ("chunk_t256_int8", 4, 256, 32, 32, 128, "int8", 1024),  # prefill_chunk 256
    ("decode_gqa_int8", 8, 1, 32, 8, 128, "int8", 511),
    ("decode_bf16", 8, 1, 32, 32, 128, "bf16", 511),
    ("verify_t5_bf16", 8, 5, 32, 32, 128, "bf16", 507),
    ("chunk_t256_bf16", 4, 256, 32, 32, 128, "bf16", 1024),
    ("decode_gqa_bf16", 8, 1, 32, 8, 128, "bf16", 511),
    ("verify_t5_gqa_int8", 8, 5, 32, 8, 128, "int8", 507),
    ("verify_t5_gqa_bf16", 8, 5, 32, 8, 128, "bf16", 507),
    ("chunk_t256_gqa_int8", 4, 256, 32, 8, 128, "int8", 1024),
    ("chunk_t256_gqa_bf16", 4, 256, 32, 8, 128, "bf16", 1024),
)
# the window arm on the tensor cores (t > 1, int8 and bf16 pages) against
# the plain version: the JAX oracle's bound (tests/test_torch_paged_attention.py)
WINDOW_RTOL = WINDOW_ATOL = 2e-5
WINDOW_TERMS = 2  # bf16 terms of q and of p: each product runs as two mma
# phase 2, the x preparation of the int8 path: m as in MATMUL_MS, llama-7b's
# two MLP shapes and a fused q|k|v layer (3 row groups)
PREP_SHAPES = ((4096, 11008, 1), (11008, 4096, 1), (4096, 4096, 3))
# phase 6a: 8 requests of 16 new tokens per run, pages of 16, f32 pages,
# the exact matmul arms: under the int8 arms a 1e-7 difference in attention
# can flip the int8 rounding of an activation and move the logits by up to
# ~2e-2 of max|logit| (LOGIT_TOL above), which no margin rule separates
# from a fault; the int8 paged engine is held to LOGIT_TOL instead
INV_ECFG = dict(n_slots=8, max_seq=1024, prefill_buckets=(128, 512, 1024))
INV_ARMS = dict(decode_dot="f32", prefill="hybrid")
INV_NEW = 16
# a greedy stream may differ from its counterpart only where, at the first
# differing token, the reference run's two highest logits lie this close
# (of max|logit|): two programs summing in other orders then pick either
MARGIN = 1e-4
SELF_DRAFT_ACCEPT = 0.95
E2E_NEW = 32
# producer: 2 layers at full width, the reference sweep's solver settings
PTQ_NSAMPLES, PTQ_SEQLEN, PPL_BATCH, PPL_WINDOWS = 8, 2048, 4, 8
PPL_RTOL = 5e-4       # kernels vs plain versions, the JAX golden test's bound
# PBW v1: OPT-1.3B's three weight shapes and llama-7b's MLP; planar at
# decode m, select at prefill m in f32 and bf16; whole-row and 128 groups
V1_SHAPES = ((2048, 2048), (2048, 8192), (8192, 2048), (4096, 11008))
V1_GROUPS = (-1, 128)
V1_EXTRA = (dict(sidecar_bits=4), dict(low_bits=2))  # at 2048x8192, whole-row scales
V1_HEADLINE = (2048, 8192)
SELECT_CROSS_MS = (1, 8, 64, 256, 512, 8192)  # the select arms' crossover rows
# planar and select sum their products in another order than the plain
# versions' torch.matmul: the JAX package's bound for its f32 kernels.  The
# bf16 select dot keeps it: a product of two bf16 values is exact in f32,
# and only the f32 summation order differs
V1_RTOL, V1_ATOL = 1e-4, 1e-4
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
# phase 2, the pair / dma / stacked kernels: decode and a 256-row window,
# and the pair kernel on a fused q|k|v layer (3 row groups)
ARM_MS = (8, 256)
ARM_LAYERS = 2        # stacked kernels: layers of the [L] planes they index
PAIR_REL = 1e-5       # of max|y|: x rounds to bf16 on both sides, only the f32 sum order differs
PAIR_MS = (1, 8, 16, 32, 64, 128, 255)  # the pair arms' crossover rows (it serves m < 256)
DMA_MS = (1, 8, 15, 64, 255)  # the dma arms' rows (it serves m < 256)
V1_MS = (1, 8, 64, 255)       # the planar arms' rows (it serves m < 256)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Median device time of a callable (CUDA events around each call), with
    the 50 MB L2 overwritten before every call: on the main path each layer
    reads its own planes cold.  A ~1 ms spin kernel runs ahead of each call,
    so the card is still busy when the host has queued it: the time is the
    device's, not the host's (host overhead shows in the e2e phase)."""

    def __init__(self):
        self.flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush_buf.zero_()
            torch.cuda._sleep(2_000_000)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)


# ---------------------------------------------------------------------------
# phase 1: set-up
# ---------------------------------------------------------------------------

def setup():
    from pb_llm_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(json.dumps({"phase": "build", "seconds": build_s, "sources": list(_build.SOURCES)}))
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_matmul(timer: Timer, card: str):
    """The int8 matmul's arms (dp4a; tensor cores "tc"; and up to
    SPLIT_MAX_M rows their decode arm "split") at every row count of INT8_MS
    on llama-7b's three shapes: each arm bit for bit with the plain version
    on its own operands and with the other arms, and within MATMUL_TOL of
    the plain version of x preparation and kernel; times of every arm, the
    plain version and the bf16 matmul of the same shape.  Logs the crossover
    per shape."""
    from pb_llm_tpu_torch.data.synthetic import random_packed_v2
    from pb_llm_tpu_torch.ops import packed_matmul as pm

    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = []
    for ic, oc in MATMUL_SHAPES:
        p = random_packed_v2(ic, oc, gen, low_frac=0.9)
        wb = torch.randn((ic, oc), generator=gen, device=DEV).to(torch.bfloat16)
        times = {}
        for m in INT8_MS:
            x = torch.randn((m, ic), generator=gen, device=DEV)
            xb = x.to(torch.bfloat16)
            want = pm.pb_int8_matmul_plain(x, p)
            scale = want.abs().max().item()
            plain_ms = timer(lambda: pm.pb_int8_matmul_plain(x, p), iters=5)
            library_ms = timer(lambda: xb @ wb)
            nbytes = (m * ic + p.n_row_groups * m * p.k_pad + 4 * (2 * m + p.n_row_groups * m
                      + 5 * oc) + 4 * p.sign_packed.numel() + p.side_val.numel() + 4 * m * oc)
            n_ops = 2 * m * oc * (ic + p.k_pad)
            bound_ms, bound_by = bound(nbytes, n_ops, INT8_OPS_PER_S)
            picked = pm.int8_arm(m, p)
            outs = {}
            for arm in pm.ARMS:
                if arm == "split" and m > pm.SPLIT_MAX_M:
                    continue
                ops = pm.prepare_int8(x, p, pm.layout_of(arm))
                got = pm.launch_int8(ops, p, arm)
                torch.cuda.synchronize()
                outs[arm] = got
                exact = torch.equal(got, pm.int8_matmul_plain(ops, p))
                err = (got - want).abs().max().item()
                if not (torch.isfinite(got).all() and exact and err <= MATMUL_TOL * scale):
                    raise AssertionError(f"pb_int8_matmul ({arm}) m={m} {ic}x{oc}: bit for bit "
                                         f"{exact}, max|err| {err} against {MATMUL_TOL} * {scale}")
                row = {"kernel": "pb_int8_matmul", "arm": arm, "picked": arm == picked, "m": m,
                       "ic": ic, "oc": oc, "k_pad": p.k_pad, "bit_for_bit": exact,
                       "max_abs_err": err, "max_rel_err": err / scale,
                       "kernel_ms": timer(lambda: pm.launch_int8(ops, p, arm)),
                       "wrapper_ms": timer(lambda: pm.pb_int8_matmul(x, p)) if arm == picked
                       else None, "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "card": card}
                if arm == "split":
                    row["ksplit"] = pm.int8_ksplit(p)
                row["bound_share"] = bound_ms / row["kernel_ms"]
                row["over_library"] = row["kernel_ms"] / library_ms
                times[m, arm] = row["kernel_ms"]
                log(json.dumps(row))
                rows.append(row)
                del ops
            if not all(torch.equal(outs["dp4a"], o) for o in outs.values()):
                raise AssertionError(f"pb_int8_matmul m={m} {ic}x{oc}: the arms differ")
            del x, xb, want, outs
        wins = [m for m in INT8_MS if times[m, "tc"] <= times[m, "dp4a"]]
        from_m = next((m for m in INT8_MS if all(k in wins for k in INT8_MS if k >= m)), None)
        log(json.dumps({"phase": "int8_crossover", "ic": ic, "oc": oc,
                        "dp4a_ms": [times[m, "dp4a"] for m in INT8_MS],
                        "tc_ms": [times[m, "tc"] for m in INT8_MS],
                        "split_ms": [times.get((m, "split")) for m in INT8_MS], "m": list(INT8_MS),
                        "tc_wins_from_m": from_m, "M_TC": pm.M_TC,
                        "DECODE_ARM": pm.DECODE_ARM, "card": card}))
        del p, wb
    return rows


def wall_ms(fn, iters: int = 20) -> float:
    """The host's wall ms of a call, the device synchronised after ``iters``
    calls queued back to back (what an eager sequence costs a step)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def check_prep(timer: Timer, card: str):
    """The int8 path's x preparation (`csrc/pb_prep_int8.cu`) against the
    eager `prepare_int8_plain`: codes and scales bit for bit, the row sums
    within `packed_matmul.sum_bound` (``sum_err_over_bound``, the largest
    ratio of a sum's difference to its bound).  ``plain_ms`` is
    the plain sequence's device time; ``*_wall_ms`` the host's wall time of
    a call (device synchronised after 20), which is what the eager sequence
    costs a step.  No single PyTorch call computes it: library_ms is null."""
    from pb_llm_tpu_torch.core.pbw import gather_x_v2, merge_packed_linears_v2
    from pb_llm_tpu_torch.data.synthetic import random_packed_v2
    from pb_llm_tpu_torch.ops import packed_matmul as pm

    gen = torch.Generator(device=DEV).manual_seed(22)
    rows = []
    for ic, oc, parts in PREP_SHAPES:
        ps = [random_packed_v2(ic, oc, gen, low_frac=0.9) for _ in range(parts)]
        p = ps[0] if parts == 1 else merge_packed_linears_v2(ps)
        for m in MATMUL_MS:
            x = torch.randn((m, ic), generator=gen, device=DEV)
            layout = pm.layout_of(pm.int8_arm(m, p))  # the main path's layout at m rows
            got = pm.prepare_int8(x, p, layout)
            torch.cuda.synchronize()
            want = pm.prepare_int8_plain(x, p, layout)
            differ = [f for f in ("x8", "sx", "xg8")
                      if not torch.equal(getattr(got, f), getattr(want, f))]
            xg = gather_x_v2(x, p).permute(2, 0, 1)
            abs_err = max((got.rs - want.rs).abs().max().item(),
                          (got.rsg - want.rsg).abs().max().item())
            sum_err = max(((got.rs - want.rs).abs() / pm.sum_bound(x, 1)).max().item(),
                          ((got.rsg - want.rsg).abs() / pm.sum_bound(xg, 2)).max().item())
            if differ or not sum_err <= 1.0:
                raise AssertionError(f"pb_prep_int8 m={m} {ic}x{p.oc}: {differ} differ from the "
                                     f"plain version; sums at {sum_err} of their bound")
            n_rg, k_pad = p.n_row_groups, p.k_pad
            nbytes = 4 * m * ic + m * ic + 4 * p.side_idx.numel() + n_rg * m * k_pad + 4 * m * (
                2 + n_rg)
            bound_ms, bound_by = bound(nbytes, 4 * m * (ic + n_rg * k_pad), F32_FLOPS_PER_S)
            xf = x.contiguous()
            row = {"kernel": "pb_prep_int8", "layout": layout, "m": m, "ic": ic, "oc": p.oc,
                   "row_groups": n_rg,
                   "k_pad": k_pad, "max_abs_err": abs_err, "sum_err_over_bound": sum_err,
                   "kernel_ms": timer(lambda: pm.launch_prep_int8(xf, p, layout)),
                   "plain_ms": timer(lambda: pm.prepare_int8_plain(x, p, layout), iters=5),
                   "kernel_wall_ms": wall_ms(lambda: pm.prepare_int8(x, p, layout)),
                   "plain_wall_ms": wall_ms(lambda: pm.prepare_int8_plain(x, p, layout)),
                   "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by, "card": card}
            log(json.dumps(row))
            rows.append(row)
        del ps, p
    return rows


def check_dma_prep(timer: Timer, card: str):
    """The dma arm "split"'s x preparation (`pb_prep_dma` in
    `csrc/pb_dma_v2.cu`) against its plain version (`packed_matmul.
    prepare_tc` with three terms) at DMA_MS's rows on 4096 and 11008
    columns of x: the terms bit for bit, the row sums within
    `packed_matmul.sum_bound`; its device time, the plain sequence's, and
    the host's wall time of a call of each (the eager step's cost).  No
    single PyTorch call computes it: library_ms is null.  Returns the row
    at HEADLINE_SHAPE."""
    from pb_llm_tpu_torch.core.pbw import gather_x_v2
    from pb_llm_tpu_torch.data.synthetic import random_packed_v2
    from pb_llm_tpu_torch.ops import decode_arms as da
    from pb_llm_tpu_torch.ops import packed_matmul as pm

    gen = torch.Generator(device=DEV).manual_seed(23)
    head = None
    for ic, oc in MATMUL_SHAPES[1:]:
        p = random_packed_v2(ic, oc, gen, low_frac=0.9)
        for m in DMA_MS:
            x = torch.randn((m, ic), generator=gen, device=DEV)
            got = da.prepare_dma(x, p, "split")
            torch.cuda.synchronize()
            want = pm.prepare_tc(x, p, 3)
            xg = gather_x_v2(x, p).permute(2, 0, 1)
            sum_err = max(((got.f32.rs - want.f32.rs).abs() / pm.sum_bound(x, 1)).max().item(),
                          ((got.f32.rsg - want.f32.rsg).abs() / pm.sum_bound(xg, 2)).max().item())
            if not (torch.equal(got.xt, want.xp) and torch.equal(got.xgp, want.xgp)
                    and sum_err <= 1.0):
                raise AssertionError(f"pb_prep_dma m={m} ic={ic}: terms differ from the plain "
                                     f"version, or sums at {sum_err} of their bound")
            nbytes = (4 * m * ic + 2 * got.xt.numel() + 2 * got.xgp.numel() + 4 * got.xt.shape[2]
                      + 4 * p.side_idx.numel() + 8 * m)
            bound_ms, bound_by = bound(nbytes, 6 * m * (got.xt.shape[2] + got.xgp.shape[3]),
                                       F32_FLOPS_PER_S)
            xf = x.contiguous()
            row = {"kernel": "pb_prep_dma", "m": m, "ic": ic, "oc": oc, "k_pad": p.k_pad,
                   "max_abs_err": max((got.f32.rs - want.f32.rs).abs().max().item(),
                                      (got.f32.rsg - want.f32.rsg).abs().max().item()),
                   "sum_err_over_bound": sum_err,
                   "kernel_ms": timer(lambda: da.launch_prep_dma(xf, p)),
                   "plain_ms": timer(lambda: pm.prepare_tc(x, p, 3), iters=5),
                   "kernel_wall_ms": wall_ms(lambda: da.prepare_dma(x, p, "split")),
                   "plain_wall_ms": wall_ms(lambda: pm.prepare_tc(x, p, 3)),
                   "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by, "card": card}
            log(json.dumps(row))
            if (m, ic, oc) == HEADLINE_SHAPE:
                head = row
            del x, got, want
        del p
    return head


def check_attention(timer: Timer, card: str):
    """Decode attention at the strip serving shape, one row per cache arm:
    int8 strips, bf16 strips, and the q8 arm (int8 q codes against int8
    strips); each in both kernel arms, "split" (the default: kernel_ms) and
    "slot" (slot_ms), in one call.  Library: SDPA in bf16 over the
    dequantized (or bf16) cache."""
    from pb_llm_tpu_torch.ops import decode_attention as da

    b, s, hq, hkv, d = ATTN_SHAPE
    gen = torch.Generator(device=DEV).manual_seed(1)
    q = torch.randn((b, hq, d), generator=gen, device=DEV)
    x = [torch.randn((b, s, hkv, d), generator=gen, device=DEV) for _ in range(2)]
    kv = []
    for t in x:
        sc = torch.clamp(t.abs().amax(-1, keepdim=True) / 127.0, min=1e-8)
        kv += [torch.clamp(torch.round(t / sc), -127, 127).to(torch.int8), sc]
    k, ks, v, vs = kv
    kb, vb = (t.to(torch.bfloat16) for t in x)
    del x
    lengths = torch.as_tensor(np.random.default_rng(2).integers(1, ATTN_MAX_LEN + 1, b), device=DEV)
    lengths[0] = ATTN_MAX_LEN
    scale = d ** -0.5
    qs = (q * scale).contiguous()
    lens = lengths.to(torch.int32)
    n = int(lengths.max())
    qd = q.to(torch.bfloat16)[:, :, None]
    mask = (torch.arange(n, device=DEV)[None, :] < lengths[:, None])[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows_read = int(lengths.sum())
    rows = []
    for arm in ATTN_ARMS:
        if arm == "bf16":
            ck, cv, kw = kb, vb, {}
            kd, vd = (t[:, :n].transpose(1, 2).contiguous() for t in (kb, vb))
            row_bytes = 2 * d * 2
        else:
            ck, cv = k, v
            kw = dict(k_scale=ks, v_scale=vs, q_int8=arm == "q8")
            kd = (k[:, :n].float() * ks[:, :n]).to(torch.bfloat16).transpose(1, 2).contiguous()
            vd = (v[:, :n].float() * vs[:, :n]).to(torch.bfloat16).transpose(1, 2).contiguous()
            row_bytes = 2 * d + 8
        want = da.decode_attention_plain(q, ck, cv, lengths, scale, **kw)
        errs = {}
        for kernel_arm in da.ARMS:
            got = da.decode_attention(q, ck, cv, lengths, scale, **kw, arm=kernel_arm)
            torch.cuda.synchronize()
            errs[kernel_arm] = (got - want).abs().max().item()
            if not (torch.isfinite(got).all()
                    and torch.all((got - want).abs() <= ATTN_ATOL + ATTN_RTOL * want.abs())):
                raise AssertionError(f"decode_attention ({arm}, {kernel_arm}): max|err| "
                                     f"{errs[kernel_arm]} beyond rtol {ATTN_RTOL} atol {ATTN_ATOL}")
        nbytes = 4 * 2 * b * hq * d + rows_read * hkv * row_bytes + 4 * b
        # q.k and p.v each take 2 operations a (row, q head, element): f32,
        # or for q8 the q.k half in int8 (its time added at the int8 peak)
        ops = 2 * rows_read * hq * d * (2 if arm != "q8" else 1 + F32_FLOPS_PER_S / INT8_OPS_PER_S)
        bound_ms, bound_by = bound(nbytes, ops, F32_FLOPS_PER_S)
        row = {"kernel": "decode_attention", "arm": arm, "B": b, "S": s, "Hq": hq, "Hkv": hkv,
               "D": d, "lengths": lengths.tolist(), "max_abs_err": errs["split"],
               "slot_max_abs_err": errs["slot"], "kernel_arm": "split",
               "kernel_ms": timer(lambda: da.launch(qs, ck, cv, lens, **kw)),
               "slot_ms": timer(lambda: da.launch(qs, ck, cv, lens, **kw, arm="slot")),
               "plain_ms": timer(lambda: da.decode_attention_plain(q, ck, cv, lengths, scale, **kw),
                                 iters=5),
               "library_ms": timer(lambda: sdpa(qd, kd, vd, attn_mask=mask, scale=scale)),
               "bound_ms": bound_ms, "bound_by": bound_by, "card": card}
        log(json.dumps(row))
        rows.append(row)
        del kd, vd, got, want
    return rows


def check_dequant(timer: Timer, card: str):
    """Binary-part dequant (the hybrid prefill's first step), f32 and bf16,
    bit for bit.  No single PyTorch call computes it: library_ms is null."""
    from pb_llm_tpu_torch.data.synthetic import random_packed_v2
    from pb_llm_tpu_torch.ops import prefill as pf

    gen = torch.Generator(device=DEV).manual_seed(7)
    rows = []
    for ic, oc in MATMUL_SHAPES:
        p = random_packed_v2(ic, oc, gen, low_frac=0.9)
        for dt in DEQUANT_DTYPES:
            got = pf.dequant_v2_binary(p, dt)
            torch.cuda.synchronize()
            want = pf.dequant_v2_binary_plain(p, dt)
            if not torch.equal(got, want):
                raise AssertionError(f"dequant {ic}x{oc} {dt}: differs from its plain version")
            nbytes = 4 * p.sign_packed.numel() + 4 * 2 * oc + got.numel() * got.element_size()
            bound_ms, bound_by = bound(nbytes, 2 * ic * oc, F32_FLOPS_PER_S)
            coef = pf._dequant_coef(p)
            row = {"kernel": "pb_dequant_v2", "ic": ic, "oc": oc, "dtype": str(dt), "max_abs_err": 0.0,
                   "kernel_ms": timer(lambda: pf.launch_dequant(p, coef, dt)),
                   "wrapper_ms": timer(lambda: pf.dequant_v2_binary(p, dt)),
                   "plain_ms": timer(lambda: pf.dequant_v2_binary_plain(p, dt), iters=5),
                   "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by, "card": card}
            log(json.dumps(row))
            rows.append(row)
        del p
    return rows


def f32_bounds(p, m: int, nbytes: int):
    """The exact f32 function's bound two ways: on the f32 CUDA cores
    (2·m·oc·(ic + k_pad) at 67 TFLOP/s) and on the bf16 tensor cores (three
    terms of that at 989 TFLOP/s), each against its bytes."""
    n_ops = 2 * m * p.oc_local * (p.ic_local + p.k_pad)
    return bound(nbytes, n_ops, F32_FLOPS_PER_S), bound(nbytes, 3 * n_ops, BF16_FLOPS_PER_S)


def check_f32_matmul(timer: Timer, card: str):
    """The exact f32 matmul's two arms (`packed_matmul.f32_arm`: the f32
    CUDA cores, the bf16 tensor cores with x in three terms) at F32_CASES on
    llama-7b's three shapes: each within F32_RTOL / F32_ATOL of the plain
    version, with both arms' kernel and preparation times, the plain
    version's, the library call's (f32 torch.matmul on the dense weight, TF32
    off) and the bound both ways; then the crossover rows F32_CROSS_MS
    (global selection), both arms' kernel times.  One row per case and arm;
    ``picked`` marks the arm the wrapper takes."""
    from pb_llm_tpu_torch.core.pbw import dequantize_v2
    from pb_llm_tpu_torch.data.synthetic import random_packed_v2
    from pb_llm_tpu_torch.ops import packed_matmul as pm

    gen = torch.Generator(device=DEV).manual_seed(8)
    rows = []

    def arms(x, p):  # each arm's (prepare, launch); "split" up to 64 rows (the decode arm)
        out = {"cores": (lambda: pm.prepare_f32(x, p), pm.launch_f32),
               "tc": (lambda: pm.prepare_tc(x, p, 3), pm.launch_f32_tc)}
        if x.shape[0] <= 64:
            out["split"] = (lambda: pm.prepare_split(x, p), pm.launch_f32_split)
        return out

    for ic, oc in MATMUL_SHAPES:
        for m, col_tile in F32_CASES:
            p = random_packed_v2(ic, oc, gen, low_frac=0.9, col_tile=col_tile)
            x = torch.randn((m, ic), generator=gen, device=DEV)
            want = pm.pb_f32_matmul_plain(x, p)
            w = dequantize_v2(p)
            nbytes = 4 * (x.numel() + p.n_row_groups * m * p.k_pad + m + p.n_row_groups * m
                          + 5 * oc + p.sign_packed.numel() + m * oc) + p.side_val.numel()
            (cores_ms, cores_by), (tc_ms, tc_by) = f32_bounds(p, m, nbytes)
            plain_ms = timer(lambda: pm.pb_f32_matmul_plain(x, p), iters=5)
            library_ms = timer(lambda: x @ w)
            for arm, (prep, launch) in arms(x, p).items():
                ops = prep()
                got = launch(ops, p)
                torch.cuda.synchronize()
                err = (got - want).abs()
                if not (torch.isfinite(got).all()
                        and torch.all(err <= F32_ATOL + F32_RTOL * want.abs())):
                    raise AssertionError(f"pb_f32_matmul ({arm}) m={m} {ic}x{oc} col_tile="
                                         f"{col_tile}: max|err| {err.max().item()} beyond rtol "
                                         f"{F32_RTOL} atol {F32_ATOL}")
                row = {"kernel": "pb_f32_matmul", "arm": arm, "picked": pm.f32_arm(m, p) == arm,
                       "m": m, "ic": ic, "oc": oc, "col_tile": p.col_tile, "k_pad": p.k_pad,
                       "max_abs_err": err.max().item(),
                       "kernel_ms": timer(lambda: launch(ops, p)), "prep_ms": timer(prep),
                       "wrapper_ms": timer(lambda: pm.pb_f32_matmul(x, p))
                       if pm.f32_arm(m, p) == arm else None,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": tc_ms if arm == "tc" else cores_ms,
                       "bound_by": tc_by if arm == "tc" else cores_by,
                       "cuda_cores_bound_ms": cores_ms, "tensor_cores_bound_ms": tc_ms,
                       "card": card}
                row["over_library"] = row["kernel_ms"] / library_ms
                log(json.dumps(row))
                rows.append(row)
                del ops, got
            del p, w
        p = random_packed_v2(ic, oc, gen, low_frac=0.9)
        times = {}
        for m in F32_CROSS_MS:
            x = torch.randn((m, ic), generator=gen, device=DEV)
            for arm, (prep, launch) in arms(x, p).items():
                ops = prep()
                times[m, arm] = timer(lambda: launch(ops, p))
        log(json.dumps({"phase": "f32_crossover", "ic": ic, "oc": oc, "m": list(F32_CROSS_MS),
                        "cores_ms": [times[m, "cores"] for m in F32_CROSS_MS],
                        "tc_ms": [times[m, "tc"] for m in F32_CROSS_MS],
                        "split_ms": [times.get((m, "split")) for m in F32_CROSS_MS],
                        "F32_TC": pm.F32_TC, "card": card}))
        del p
    return rows


def check_f32_split(timer: Timer, card: str):
    """The exact f32 matmul's decode rows (F32_SPLIT_MS, below F32_TC) on
    llama-7b's three shapes and a fused q|k|v layer (3 row groups): its
    three arms ("split", the dma kernel's device code; "cores"; "tc" by
    name), flat and, on layer 1 of a 2-layer stack, through the stacked
    entry, on the same operands; each within F32_RTOL / F32_ATOL of the plain
    version, the stacked launch equal to the flat one bit for bit.  Times:
    each arm's kernel and preparation, the wrapper's, the plain version's,
    the f32 torch.matmul on the dense weight (TF32 off), and each arm's
    bound (the bytes, or its own arithmetic: three terms at the bf16 rate
    for "split" and "tc", the f32 rate for "cores").  One row per layer and
    m; ``picked`` names the arm the wrapper takes."""
    from pb_llm_tpu_torch.core.pbw import dequantize_v2, merge_packed_linears_v2
    from pb_llm_tpu_torch.data.synthetic import random_packed_v2
    from pb_llm_tpu_torch.models import stacking
    from pb_llm_tpu_torch.ops import packed_matmul as pm

    gen = torch.Generator(device=DEV).manual_seed(23)
    layers = [(f"{ic}x{oc}", [random_packed_v2(ic, oc, gen, low_frac=0.9)
                              for _ in range(ARM_LAYERS)]) for ic, oc in MATMUL_SHAPES]
    layers.append(("fused q|k|v", [merge_packed_linears_v2(
        [random_packed_v2(4096, 4096, gen, low_frac=0.9) for _ in range(3)])]))
    rows = []
    for name, ls in layers:
        p, mk = ls[-1], None
        if len(ls) > 1:
            sp = stacking.stack_layers({"layers": [{"w": q} for q in ls]})["layers_stacked"]["w"]
            li = len(ls) - 1
            mk = stacking.StackedPackedLinearV2(sp, li, torch.full((1,), li, dtype=torch.int32,
                                                                   device=DEV))
            p = pm.stacked_layer(mk)
        ic, oc = p.ic_local, p.oc_local
        w = dequantize_v2(p)
        for m in F32_SPLIT_MS:
            x = torch.randn((m, ic), generator=gen, device=DEV)
            want = pm.pb_f32_matmul_plain(x, p)
            n_ops, nbytes = 2 * m * oc * (ic + p.k_pad), matmul_bytes(p, m)
            row = {"kernel": "pb_f32_matmul", "layer": name, "m": m, "ic": ic, "oc": oc,
                   "k_pad": p.k_pad, "row_groups": p.n_row_groups, "picked": pm.f32_arm(m, p),
                   "ksplit": pm.split_ksplit(p),
                   "plain_ms": timer(lambda: pm.pb_f32_matmul_plain(x, p), iters=5),
                   "wrapper_ms": timer(lambda: pm.pb_f32_matmul(x, p)),
                   "library_ms": timer(lambda: x @ w), "library": "f32 matmul", "card": card}
            for arm in pm.F32_ARMS:
                ops = pm.prepare_f32_arm(x, p, arm)
                got = pm.launch_f32(ops, p)
                torch.cuda.synchronize()
                err = (got - want).abs()
                if not (torch.isfinite(got).all()
                        and torch.all(err <= F32_ATOL + F32_RTOL * want.abs())):
                    raise AssertionError(f"pb_f32_matmul ({arm}) m={m} {name}: max|err| "
                                         f"{err.max().item()} beyond rtol {F32_RTOL} atol "
                                         f"{F32_ATOL}")
                b_ms, b_by = (bound(nbytes, n_ops, F32_FLOPS_PER_S) if arm == "cores"
                              else bound(nbytes, 3 * n_ops, BF16_FLOPS_PER_S))
                row.update({f"{arm}_ms": timer(lambda: pm.launch_f32(ops, p)),
                            f"{arm}_prep_ms": timer(lambda: pm.prepare_f32_arm(x, p, arm)),
                            f"{arm}_max_abs_err": err.max().item(), f"{arm}_bound_ms": b_ms,
                            f"{arm}_bound_by": b_by})
                row[f"{arm}_share_of_bound"] = b_ms / row[f"{arm}_ms"]
                if mk is not None:
                    sgot = pm.launch_f32_stacked(ops, mk)
                    torch.cuda.synchronize()
                    if not torch.equal(sgot, got):
                        raise AssertionError(f"pb_f32_matmul_stacked ({arm}) m={m} {name}: "
                                             "the stacked launch differs from the flat one")
                    row[f"stacked_{arm}_ms"] = timer(lambda: pm.launch_f32_stacked(ops, mk))
                del ops, got, err
            pk = row["picked"]
            row.update({"arm": pk, "kernel_ms": row[f"{pk}_ms"],
                        "max_abs_err": row[f"{pk}_max_abs_err"], "bound_ms": row[f"{pk}_bound_ms"],
                        "bound_by": row[f"{pk}_bound_by"]})
            row["over_library"] = row["kernel_ms"] / row["library_ms"]
            log(json.dumps(row))
            rows.append(row)
            del x, want
        del ls, p, mk, w
    return rows


def check_flash(timer: Timer, card: str):
    """Flash attention at the eval windows' shapes, both arms ("tc", which
    every call takes, and "cores") in the same call, f32 and, on "tc",
    dots_bf16; library: SDPA (f32, and bf16 beside dots_bf16) on the same
    tensors.  Bounds: the f32 CUDA cores' 4·D operations a (row, allowed
    key) pair at 67 TFLOP/s, and the tensor cores' issued products × 2·D at
    989 TFLOP/s."""
    from pb_llm_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=DEV).manual_seed(9)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for b, t, h, d, causal in FLASH_CASES:
        q, k, v = (torch.randn((b, t, h, d), generator=gen, device=DEV) for _ in range(3))
        scale = d ** -0.5
        want = fa.flash_attention_plain(q, k, v, scale, causal=causal)
        want_bf16 = fa.flash_attention_plain(q, k, v, scale, causal=causal, dots_bf16=True)
        errs = {}
        for arm, bf16 in (("tc", False), ("cores", False), ("tc", True)):
            got = fa.flash_attention(q, k, v, scale, causal=causal, arm=arm, dots_bf16=bf16)
            torch.cuda.synchronize()
            ref, tol = (want_bf16, FLASH_BF16_TOL) if bf16 else (want, FLASH_RTOL)
            err = (got - ref).abs()
            if not (torch.isfinite(got).all() and torch.all(err <= tol + tol * ref.abs())):
                raise AssertionError(f"flash_attention {arm} {(b, t, h, d, causal)} dots_bf16 "
                                     f"{bf16}: max|err| {err.max().item()} beyond rtol = atol "
                                     f"= {tol}")
            errs[arm, bf16] = err.max().item()
            del got, err
        del want, want_bf16
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        qb, kb, vb = (a.to(torch.bfloat16) for a in (qt, kt, vt))
        pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
        nbytes = 4 * 4 * b * t * h * d
        n_tc = sum(len(pr) for pr in fa.tc_products(False))
        bound_ms, bound_by = bound(nbytes, 2 * d * pairs * n_tc, BF16_FLOPS_PER_S)
        cores_bound_ms, cores_bound_by = bound(nbytes, 4 * d * pairs, F32_FLOPS_PER_S)
        bf16_bound_ms, _ = bound(nbytes, 4 * d * pairs, BF16_FLOPS_PER_S)

        def arm_ms(arm, bf16=False):
            return timer(lambda: fa.flash_attention(q, k, v, scale, causal=causal, arm=arm,
                                                    dots_bf16=bf16), iters=10)

        row = {"kernel": "flash_attention", "arm": fa.flash_arm(), "B": b, "T": t, "H": h,
               "D": d, "causal": causal, "max_abs_err": errs["tc", False],
               "cores_max_abs_err": errs["cores", False], "bf16_max_abs_err": errs["tc", True],
               "kernel_ms": arm_ms("tc"), "cores_ms": arm_ms("cores"),
               "bf16_ms": arm_ms("tc", True),
               "plain_ms": timer(lambda: fa.flash_attention_plain(q, k, v, scale, causal=causal),
                                 iters=3, warmup=1),
               "library_ms": timer(lambda: sdpa(qt, kt, vt, is_causal=causal, scale=scale), iters=10),
               "library_bf16_ms": timer(lambda: sdpa(qb, kb, vb, is_causal=causal, scale=scale),
                                        iters=10),
               "bound_ms": bound_ms, "bound_by": bound_by, "tc_products": n_tc,
               "cores_bound_ms": cores_bound_ms, "cores_bound_by": cores_bound_by,
               "bf16_bound_ms": bf16_bound_ms, "card": card}
        row["over_library"] = row["kernel_ms"] / row["library_ms"]
        log(json.dumps(row))
        rows.append(row)
        del q, k, v, qt, kt, vt, qb, kb, vb
    return rows


def paged_operands(b, t, hq, hkv, d, kind, max_base, gen, rng, bases=None):
    """A PAGED_CASES case's inputs on the card: a PAGED_POOL pool of
    ``kind`` pages (int8 with f32 scale planes, bf16 or f32), shuffled
    tables, bases up to ``max_base`` (slot 0's the largest; or ``bases``),
    q [B, t, Hq, D]; every page no row may read holds NaN (the values, or an
    int8 page's scales).  Returns q, k, v, k scales, v scales, table, base."""
    n_pages, ps, maxp = PAGED_POOL
    kv = [torch.randn((n_pages + 1, hkv, ps, d), generator=gen, device=DEV) for _ in range(2)]
    int8 = kind == "int8"
    if int8:
        scaled = []
        for x in kv:
            sc = torch.clamp(x.abs().amax(-1) / 127.0, min=1e-8)
            q8 = torch.clamp(torch.round(x / sc[..., None]), -127, 127).to(torch.int8)
            scaled += [q8, sc]
        k, ks, v, vs = scaled
    else:
        (k, v), ks, vs = [x.to(torch.bfloat16 if kind == "bf16" else torch.float32)
                          for x in kv], None, None
    del kv
    table = torch.randperm(n_pages, generator=gen, device=DEV)[: b * maxp].reshape(b, maxp)
    table = table.to(torch.int32)
    if bases is None:
        base = torch.as_tensor(rng.integers(0, max_base + 1, b), device=DEV)
        base[0] = max_base
    else:
        base = torch.as_tensor(bases, device=DEV)
    live = torch.zeros(n_pages + 1, dtype=torch.bool, device=DEV)
    for i, bs in enumerate(base.tolist()):
        live[table[i, : -(-(bs + t) // ps)].long()] = True
    if int8:  # no key past a row's limit may reach the output: poison the rest
        ks[~live], vs[~live] = float("nan"), float("nan")
    else:
        k[~live], v[~live] = float("nan"), float("nan")
    q = torch.randn((b, t, hq, d), generator=gen, device=DEV)
    return q, k, v, ks, vs, table, base


def check_paged_attention(timer: Timer, card: str):
    """Paged attention on a pool of 1025 pages of 16 through shuffled
    tables, at the paged serving path's shapes, over int8, f32 and bf16
    pages; every page no row may read (the trash page, the tables' entries
    past each slot's last live page) holds NaN (the values, or an int8
    page's scales).  Every arm that takes a case runs on the same inputs in
    this call and is held to its bound: decode on "split" and the CUDA
    cores; windows on the tensor cores and the CUDA cores, and on
    "split" where t·G <= SPLIT_MAX_ROWS (the verify_t5 cases of G = 1).
    Library: SDPA over the same K/V gathered into dense strips beforehand
    (bf16 for int8 and bf16 pages, as for decode attention; f32 for f32
    pages; NaN zeroed); the gather is not timed."""
    from pb_llm_tpu_torch.ops import paged_attention as tpa

    n_pages, ps, maxp = PAGED_POOL
    gen = torch.Generator(device=DEV).manual_seed(12)
    rng = np.random.default_rng(13)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for name, b, t, hq, hkv, d, kind, max_base in PAGED_CASES:
        q, k, v, ks, vs, table, base = paged_operands(b, t, hq, hkv, d, kind, max_base, gen, rng)
        scale = d ** -0.5
        got = tpa.paged_attention_multi(q, k, v, table, base, scale, ps, ks, vs)
        torch.cuda.synchronize()
        want = tpa.paged_attention_plain(q, k, v, table, base, scale, ps, ks, vs)
        err = (got - want).abs()
        if not (torch.isfinite(got).all() and torch.all(err <= ATTN_ATOL + ATTN_RTOL * want.abs())):
            raise AssertionError(f"paged_attention {name}: max|err| {err.max().item()} beyond "
                                 f"rtol {ATTN_RTOL} atol {ATTN_ATOL}")
        arm = tpa.window_arm(t, k.dtype, hq // hkv, d)
        runs = [tpa.CUDA_CORES]  # every arm that takes the case
        if t > 1 and kind != "f32":
            runs.append(tpa.TENSOR_CORES)
        if tpa.split_ok(t * (hq // hkv), d):
            runs.append(tpa.SPLIT)
        qs, bs = (q * scale).contiguous(), base.to(torch.int32)
        arm_err = {}
        for a in runs:
            got_a = tpa.launch(qs, k, v, table, bs, ks, vs, _arm_for_timing=a)
            e = (got_a - want).abs()
            arm_err[a] = e.max().item()
            rtol, atol = ((WINDOW_RTOL, WINDOW_ATOL) if a == tpa.TENSOR_CORES
                          else (ATTN_RTOL, ATTN_ATOL))
            if not (torch.isfinite(got_a).all() and torch.all(e <= atol + rtol * want.abs())):
                raise AssertionError(f"paged_attention {name} ({a}): max|err| {arm_err[a]} "
                                     f"beyond rtol {rtol} atol {atol}")
            if t == 1 and a == tpa.SPLIT:  # the arm's own plain version, too
                sp = tpa.split_plain(q[:, 0], k, v, table, base + 1, scale, ps, ks, vs)
                if not torch.all((got_a[:, 0] - sp).abs() <= ATTN_ATOL + ATTN_RTOL * sp.abs()):
                    raise AssertionError(f"paged_attention {name} ({a}): beyond split_plain")
            del e, got_a

        n = -(-int((base + t).max()) // ps)
        idx = table[:, :n].long()
        ldt = torch.float32 if kind == "f32" else torch.bfloat16

        def dense(pages, sc):  # [B, Hkv, S, D] in the library's type
            x = pages[idx].transpose(2, 3).reshape(b, n * ps, hkv, d).float()
            if sc is not None:
                x = x * sc[idx].transpose(2, 3).reshape(b, n * ps, hkv, 1)
            return torch.nan_to_num(x, nan=0.0).transpose(1, 2).to(ldt).contiguous()

        kd, vd = dense(k, ks), dense(v, vs)
        qd = q.transpose(1, 2).to(ldt).contiguous()
        lim = base[:, None] + 1 + torch.arange(t, device=DEV)[None, :]
        mask = (torch.arange(n * ps, device=DEV)[None, None, :] < lim[:, :, None])[:, None]
        pairs = int(lim.sum())                 # (row, allowed key) pairs per q head
        live = int((base + t).sum())           # keys read per kv head
        row_bytes = {"int8": 2 * d + 8, "bf16": 4 * d, "f32": 8 * d}[kind]
        nbytes = 4 * 2 * b * t * hq * d + live * hkv * row_bytes + 4 * (b * n + b)
        # q.k and p.v: 4*D operations a (row, allowed key) per q head; on the
        # tensor cores each product runs once per bf16 term
        bounds = {tpa.CUDA_CORES: bound(nbytes, 4 * d * hq * pairs, F32_FLOPS_PER_S),
                  tpa.TENSOR_CORES: bound(nbytes, WINDOW_TERMS * 4 * d * hq * pairs,
                                          BF16_FLOPS_PER_S)}
        bounds[tpa.SPLIT] = bounds[tpa.CUDA_CORES]  # f32 on the CUDA cores too
        bound_ms, bound_by = bounds[arm]
        plain_iters = 3 if t > 8 else 5
        row = {"kernel": "paged_attention", "case": name, "arm": arm, "B": b, "t": t, "Hq": hq,
               "Hkv": hkv, "D": d, "page": ps, "pages": n_pages + 1, "kv": kind,
               "bases": base.tolist(), "max_abs_err": err.max().item(),
               "kernel_ms": timer(lambda: tpa.launch(qs, k, v, table, bs, ks, vs, decode=t == 1)),
               "wrapper_ms": timer(lambda: tpa.paged_attention_multi(q, k, v, table, base, scale,
                                                                     ps, ks, vs)),
               "plain_ms": timer(lambda: tpa.paged_attention_plain(q, k, v, table, base, scale, ps,
                                                                   ks, vs), iters=plain_iters),
               "library_ms": timer(lambda: sdpa(qd, kd, vd, attn_mask=mask, scale=scale,
                                                enable_gqa=hq != hkv)),
               "bound_ms": bound_ms, "bound_by": bound_by, "card": card}
        for a in runs:  # every arm on the same inputs, in the same call
            row[f"{a}_max_abs_err"] = arm_err[a]
            row[f"{a}_ms"] = timer(lambda: tpa.launch(qs, k, v, table, bs, ks, vs,
                                                        decode=t == 1, _arm_for_timing=a))
            row[f"{a}_bound_ms"], row[f"{a}_bound_by"] = bounds[a]
        log(json.dumps(row))
        rows.append(row)
        del k, v, ks, vs, kd, vd, got, want, err
    return rows


def v1_plane_bytes(p) -> int:
    return sum(t.numel() * t.element_size() for t in
               (p.sign_packed, p.mask_packed, p.sidecar, p.low_scale, p.low_mean, p.high_scale,
                p.high_zero) + ((p.bias,) if p.bias is not None else ()))


def check_v1_matmul(timer: Timer, card: str):
    """The PBW-v1 planar kernel at the rows of V1_MS and the select kernel
    at prefill m (f32 and bf16) against their plain versions, at OPT-1.3B's
    and llama-7b's MLP shapes, whole-row and 128-row scale groups, plus one
    nibble-code and one 2-bit-low layer.  The planar kernel's two arms
    ("tc", bf16 tensor cores, C, M, V exact and x in three terms; "cores",
    f32 CUDA cores) and select "tc" on
    the same x (the same function, its terms launch included) in the same
    call; the select kernel's two arms ("tc", bf16 tensor cores, x and w in
    bf16 terms; "cores", f32 CUDA cores) likewise; each as its wrapper's
    whole call, with the bytes bound and each arm's operations bound
    (planar "tc": 3 planes × 3 terms × 2·m·ic·oc at the bf16 rate; planar
    "cores": the function's 2·m·ic·oc at the f32 rate, its own 3 products
    beside as cores_arith_ms), and a crossover line per shape
    (SELECT_CROSS_MS).  Library: one torch.matmul
    of x with the dense dequantized weight, f32 (TF32 off) and bf16."""
    from pb_llm_tpu_torch.core.pbw import dequantize
    from pb_llm_tpu_torch.data.synthetic import random_packed_v1
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

    gen = torch.Generator(device=DEV).manual_seed(17)
    cases = [(ic, oc, dict(groupsize=gs)) for ic, oc in V1_SHAPES for gs in V1_GROUPS]
    cases += [(*V1_HEADLINE, kw) for kw in V1_EXTRA]
    rows = []
    for ic, oc, kw in cases:
        p = random_packed_v1(ic, oc, gen, low_frac=0.9, bias=True, **kw)
        w = dequantize(p)
        wb = w.to(torch.bfloat16)
        for m, kernel, dot in ([(m, "planar", torch.float32) for m in V1_MS]
                               + [(MATMUL_MS[1], "select", torch.float32),
                                  (MATMUL_MS[1], "select", torch.bfloat16)]):
            if kw.keys() - {"groupsize"} and dot == torch.bfloat16:
                continue
            x = torch.randn((m, ic), generator=gen, device=DEV)
            if kernel == "planar":
                arms = {a: functools.partial(v1.launch_planar, x, p, a) for a in v1.PLANAR_ARMS}
                wrapper, plain = (functools.partial(f, x, p) for f in (
                    v1.pb_planar_v1, v1.pb_planar_v1_plain))
            else:
                arms = {a: functools.partial(v1.launch_select, x, p, dot, a) for a in v1.SELECT_ARMS}
                wrapper, plain = (functools.partial(f, x, p, dot) for f in (
                    v1.pb_select_v1, v1.pb_select_v1_plain))
            want = plain()
            errs = {}
            for a, launch in arms.items():
                got = launch()
                torch.cuda.synchronize()
                err = (got - want).abs()
                if not (torch.isfinite(got).all() and torch.all(err <= V1_ATOL + V1_RTOL * want.abs())):
                    raise AssertionError(f"pb_{kernel}_v1 ({a}) m={m} {ic}x{oc} {kw} {dot}: max|err| "
                                         f"{err.max().item()} beyond rtol {V1_RTOL} atol {V1_ATOL}")
                errs[a] = err.max().item()
                del got, err
            nbytes = 4 * (m * ic + m * oc) + v1_plane_bytes(p)
            peak = BF16_FLOPS_PER_S if dot == torch.bfloat16 else F32_FLOPS_PER_S
            picked = v1.planar_arm(p) if kernel == "planar" else v1.select_arm(m, p)
            xb = x.to(torch.bfloat16)
            row = {"kernel": f"pb_{kernel}_v1", "arm": picked, "m": m, "ic": ic, "oc": oc,
                   "groupsize": p.groupsize, "sidecar_bits": p.sidecar_bits,
                   "low_bits": p.low_bits, "dot": str(dot), "max_abs_err": errs[picked],
                   "kernel_ms": timer(arms[picked]), "wrapper_ms": timer(wrapper),
                   "plain_ms": timer(plain, iters=5),
                   "library_f32_ms": timer(lambda: x @ w), "library_bf16_ms": timer(lambda: xb @ wb),
                   "card": card}
            # the CUDA cores' bound 2·m·ic·oc at the f32 (or, bf16 dot, the bf16) rate;
            # the tensor cores' the issued products × 2·m·ic·oc at the bf16 rate (planar
            # "tc": 3 planes × 3 terms)
            bounds = {"cores": bound(nbytes, 2 * m * ic * oc, peak)}
            if kernel == "planar":
                bounds["tc"] = bound(nbytes, 9 * 2 * m * ic * oc, BF16_FLOPS_PER_S)
                row.update({"tile": v1.PLANAR_OC, "ksplit": v1.planar_ksplit(p),
                            "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                            "cores_arith_ms": 3 * 2 * m * ic * oc / F32_FLOPS_PER_S * 1e3,
                            "select_tc_ms": timer(functools.partial(
                                v1.launch_select, x, p, torch.float32, "tc"))})
                for a in arms:
                    row[f"{a}_max_abs_err"] = errs[a]
                    row[f"{a}_ms"] = row["kernel_ms"] if a == picked else timer(arms[a])
                for a in v1.PLANAR_ARMS:
                    row[f"{a}_bound_ms"], row[f"{a}_bound_by"] = bounds[a]
                row["share_of_bound"] = bounds[picked][0] / row["kernel_ms"]
            if kernel == "select":
                n_tc = len(v1.select_products(dot))
                bounds["tc"] = bound(nbytes, n_tc * 2 * m * ic * oc, BF16_FLOPS_PER_S)
                row["tc_products"] = n_tc
                for a in v1.SELECT_ARMS:
                    row[f"{a}_max_abs_err"] = errs[a]
                    row[f"{a}_ms"] = row["kernel_ms"] if a == picked else timer(arms[a])
                    row[f"{a}_bound_ms"], row[f"{a}_bound_by"] = bounds[a]
            row["bound_ms"], row["bound_by"] = bounds[picked]
            row["over_library_f32"] = row["kernel_ms"] / row["library_f32_ms"]
            log(json.dumps(row))
            rows.append(row)
            del x, xb, want
        if kw == dict(groupsize=-1):  # the select arms' crossover on this shape
            times = {}
            for m in SELECT_CROSS_MS:
                x = torch.randn((m, ic), generator=gen, device=DEV)
                it = 5 if m > 1024 else 20
                for a in v1.SELECT_ARMS:
                    times[m, a] = timer(functools.partial(v1.launch_select, x, p, torch.float32, a),
                                        iters=it)
                times[m, "library_f32"] = timer(lambda: x @ w, iters=it)
                nbytes = 4 * (m * ic + m * oc) + v1_plane_bytes(p)
                times[m, "tc_bound"] = bound(nbytes, len(v1.SELECT_TERMS) * 2 * m * ic * oc,
                                             BF16_FLOPS_PER_S)[0]
                times[m, "cores_bound"] = bound(nbytes, 2 * m * ic * oc, F32_FLOPS_PER_S)[0]
                if m == SELECT_CROSS_MS[-1]:
                    times[m, "plain"] = timer(functools.partial(v1.pb_select_v1_plain, x, p),
                                              iters=3, warmup=1)
                del x
            log(json.dumps({"phase": "select_crossover", "ic": ic, "oc": oc,
                            "m": list(SELECT_CROSS_MS),
                            **{f"{a}_ms": [times[m, a] for m in SELECT_CROSS_MS]
                               for a in (*v1.SELECT_ARMS, "library_f32", "tc_bound", "cores_bound")},
                            "plain_ms_at_{}".format(SELECT_CROSS_MS[-1]):
                                times[SELECT_CROSS_MS[-1], "plain"],
                            "ksplit": [v1.select_ksplit(m, p, torch.cuda.get_device_properties(
                                DEV).multi_processor_count) for m in SELECT_CROSS_MS],
                            "SELECT_TC": v1.SELECT_TC, "card": card}))
        del w, wb
        del p
    return rows


def matmul_bytes(p, m: int) -> int:
    """The packed matmul's least bytes: sign planes, codes, x and y rows."""
    return 4 * p.sign_packed.numel() + p.side_val.numel() + 4 * m * (p.ic_local + p.oc_local)


def check_pair_arms(timer: Timer, card: str):
    """The pair kernel's three arms (`decode_arms.pair_arm`: "mma", the
    mma.sync kernel; "split" and "tc", the wgmma code with and without its K
    split over blocks) at every row count of PAIR_MS on llama-7b's three
    shapes and on a fused q|k|v layer (3 row groups of 4096 columns): each
    within PAIR_REL of max|y| of the plain version, with its kernel time and
    its operands' preparation time, the plain version's, the bf16 matmul's on
    the dense weight and the bound (bytes, or the bf16 tensor cores' 2·m·oc·
    (ic + k_pad)).  ``picked`` marks the arm the wrapper takes; a crossover
    line per layer gives the three arms' times by m."""
    from pb_llm_tpu_torch.core.pbw import dequantize_v2, merge_packed_linears_v2
    from pb_llm_tpu_torch.data.synthetic import random_packed_v2
    from pb_llm_tpu_torch.ops import decode_arms as da

    gen = torch.Generator(device=DEV).manual_seed(21)
    rows = []
    layers = [(f"{ic}x{oc}", random_packed_v2(ic, oc, gen, low_frac=0.9))
              for ic, oc in MATMUL_SHAPES]
    layers.append(("fused q|k|v", merge_packed_linears_v2(
        [random_packed_v2(4096, 4096, gen, low_frac=0.9) for _ in range(3)])))
    for name, p in layers:
        ic, oc = p.ic_local, p.oc_local
        wb = dequantize_v2(p).to(torch.bfloat16)
        times = {}
        for m in PAIR_MS:
            x = torch.randn((m, ic), generator=gen, device=DEV)
            xb = x.to(torch.bfloat16)
            want = da.pb_pair_v2_plain(x, p)
            scale = want.abs().max().item()
            plain_ms = timer(lambda: da.pb_pair_v2_plain(x, p), iters=5)
            library_ms = timer(lambda: xb @ wb)
            bound_ms, bound_by = bound(matmul_bytes(p, m), 2 * m * oc * (ic + p.k_pad),
                                       BF16_FLOPS_PER_S)
            for arm in da.PAIR_ARMS:
                layout = "mma" if arm == "mma" else "tc"
                ops = da.prepare_pair(x, p, layout)
                got = da.launch_pair(ops, p, arm)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                if not (torch.isfinite(got).all() and err <= PAIR_REL * scale):
                    raise AssertionError(f"pb_pair_v2 ({arm}) m={m} {name}: max|err| {err} "
                                         f"against {PAIR_REL} * {scale}")
                row = {"kernel": "pb_pair_v2", "arm": arm, "picked": da.pair_arm(m, p) == arm,
                       "layer": name, "m": m, "ic": ic, "oc": oc, "k_pad": p.k_pad,
                       "row_groups": p.n_row_groups, "max_abs_err": err,
                       "max_rel_err": err / scale, "kernel_ms": timer(lambda: da.launch_pair(
                           ops, p, arm)),
                       "prep_ms": timer(lambda: da.prepare_pair(x, p, layout)),
                       "wrapper_ms": timer(lambda: da.pb_pair_v2(x, p))
                       if da.pair_arm(m, p) == arm else None,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "library": "bf16 matmul", "bound_ms": bound_ms, "bound_by": bound_by,
                       "ksplit": da.pair_ksplit(p) if arm == "split" else 1, "card": card}
                row["over_library"] = row["kernel_ms"] / library_ms
                times[m, arm] = row["kernel_ms"]
                log(json.dumps(row))
                rows.append(row)
                del ops, got
        log(json.dumps({"phase": "pair_crossover", "layer": name, "m": list(PAIR_MS),
                        **{f"{arm}_ms": [times[m, arm] for m in PAIR_MS] for arm in da.PAIR_ARMS},
                        "PAIR_TC": da.PAIR_TC, "card": card}))
        del wb
    return rows


def check_dma_arms(timer: Timer, card: str):
    """The dma kernel's two arms (`decode_arms.dma_arm`: "split", the bf16
    tensor cores with x in three exact terms and a K split in a cluster;
    "cores", the f32 CUDA cores) at every row count of DMA_MS on llama-7b's
    three shapes (random PBW-v2 planes, low_frac 0.9, 8-bit codes): each
    within F32_RTOL / F32_ATOL of the plain version, with its kernel time,
    its operands' preparation time (the split arm's one launch; the cores
    arm's PyTorch ops), the wrapper's time, the plain version's, the f32
    and bf16 torch.matmul on the dense weight (TF32 off), and its bound:
    the bytes, or the arm's own arithmetic (split: three terms, 3 · 2·m·oc·
    (ic + k_pad) at the bf16 rate; cores: 2·m·oc·(ic + k_pad) at the f32
    rate).  ``picked`` names the arm the wrapper takes."""
    from pb_llm_tpu_torch.core.pbw import dequantize_v2
    from pb_llm_tpu_torch.data.synthetic import random_packed_v2
    from pb_llm_tpu_torch.ops import decode_arms as da

    gen = torch.Generator(device=DEV).manual_seed(22)
    rows = []
    for ic, oc in MATMUL_SHAPES:
        p = random_packed_v2(ic, oc, gen, low_frac=0.9)
        w = dequantize_v2(p)
        wb = w.to(torch.bfloat16)
        for m in DMA_MS:
            x = torch.randn((m, ic), generator=gen, device=DEV)
            xb = x.to(torch.bfloat16)
            want = da.pb_dma_v2_plain(x, p)
            n_ops = 2 * m * oc * (ic + p.k_pad)
            nbytes = matmul_bytes(p, m)
            row = {"kernel": "pb_dma_v2", "m": m, "ic": ic, "oc": oc, "k_pad": p.k_pad,
                   "picked": da.dma_arm(p), "ksplit": da.dma_ksplit(p),
                   "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "plain_ms": timer(lambda: da.pb_dma_v2_plain(x, p), iters=5),
                   "wrapper_ms": timer(lambda: da.pb_dma_v2(x, p)),
                   "library_f32_ms": timer(lambda: x @ w),
                   "library_bf16_ms": timer(lambda: xb @ wb), "card": card}
            for arm in da.DMA_ARMS:
                ops = da.prepare_dma(x, p, arm)
                got = da.launch_dma(ops, p)
                torch.cuda.synchronize()
                err = (got - want).abs()
                if not (torch.isfinite(got).all()
                        and torch.all(err <= F32_ATOL + F32_RTOL * want.abs())):
                    raise AssertionError(f"pb_dma_v2 ({arm}) m={m} {ic}x{oc}: max|err| "
                                         f"{err.max().item()} beyond rtol {F32_RTOL} atol "
                                         f"{F32_ATOL}")
                ms = timer(lambda: da.launch_dma(ops, p))
                b_ms, b_by = (bound(nbytes, 3 * n_ops, BF16_FLOPS_PER_S) if arm == "split"
                              else bound(nbytes, n_ops, F32_FLOPS_PER_S))
                row.update({f"{arm}_ms": ms, f"{arm}_max_abs_err": err.max().item(),
                            f"{arm}_prep_ms": timer(lambda: da.prepare_dma(x, p, arm)),
                            f"{arm}_bound_ms": b_ms, f"{arm}_bound_by": b_by,
                            f"{arm}_share_of_bound": b_ms / ms})
                del ops, got, err
            pk = row["picked"]
            row.update({"arm": pk, "kernel_ms": row[f"{pk}_ms"],
                        "max_abs_err": row[f"{pk}_max_abs_err"],
                        "bound_ms": row[f"{pk}_bound_ms"], "bound_by": row[f"{pk}_bound_by"],
                        "library_ms": row["library_f32_ms"]})
            row["over_library_f32"] = row["kernel_ms"] / row["library_f32_ms"]
            log(json.dumps(row))
            rows.append(row)
            del x, xb, want
        del p, w, wb
    return rows


def check_v2_arms(timer: Timer, card: str):
    """Phase 9's stacked kernels at llama-7b's decode shapes (random PBW-v2
    planes, low_frac 0.9): the stacked int8 and f32 kernels on layer 1 of
    a 2-layer stack (the stacked f32 entry in every arm).  Library: the
    bf16 torch.matmul on the dense weight for stacked int8, the f32 one for
    stacked f32 (TF32 off).  dma: `check_dma_arms`."""
    from pb_llm_tpu_torch.core.pbw import dequantize_v2
    from pb_llm_tpu_torch.data.synthetic import random_packed_v2
    from pb_llm_tpu_torch.models import stacking
    from pb_llm_tpu_torch.ops import packed_matmul as pm

    gen = torch.Generator(device=DEV).manual_seed(20)
    rows = []

    def record(kernel, p, m, got, want, launch, wrapper, plain, library, bf16, **extra):
        torch.cuda.synchronize()
        err = (got - want).abs()
        scale = want.abs().max().item()
        if kernel == "pb_int8_matmul_stacked":
            ok = err.max().item() <= MATMUL_TOL * scale
        else:
            ok = bool(torch.all(err <= F32_ATOL + F32_RTOL * want.abs()))
        if not (torch.isfinite(got).all() and ok):
            raise AssertionError(f"{kernel} m={m} {p.ic_local}x{p.oc_local}: max|err| "
                                 f"{err.max().item()} (max|y| {scale})")
        n_ops = 2 * m * p.oc_local * (p.ic_local + p.k_pad)
        peak = INT8_OPS_PER_S if kernel == "pb_int8_matmul_stacked" else F32_FLOPS_PER_S
        bound_ms, bound_by = bound(matmul_bytes(p, m), n_ops, peak)
        row = {"kernel": kernel, "m": m, "ic": p.ic_local, "oc": p.oc_local, "k_pad": p.k_pad,
               "row_groups": p.n_row_groups, "max_abs_err": err.max().item(),
               "max_rel_err": err.max().item() / scale, "kernel_ms": timer(launch),
               "wrapper_ms": timer(wrapper), "plain_ms": timer(plain, iters=5),
               "library_ms": timer(library), "library": "bf16 matmul" if bf16 else "f32 matmul",
               "bound_ms": bound_ms, "bound_by": bound_by, "card": card, **extra}
        log(json.dumps(row))
        rows.append(row)

    for ic, oc in MATMUL_SHAPES:
        layers = [random_packed_v2(ic, oc, gen, low_frac=0.9) for _ in range(ARM_LAYERS)]
        p = layers[1]
        sp = stacking.stack_layers({"layers": [{"w": q} for q in layers]})["layers_stacked"]["w"]
        mk = stacking.StackedPackedLinearV2(sp, 1, torch.ones(1, dtype=torch.int32, device=DEV))
        w = dequantize_v2(p)
        wb = w.to(torch.bfloat16)
        for m in ARM_MS:
            x = torch.randn((m, ic), generator=gen, device=DEV)
            xb = x.to(torch.bfloat16)
            lp = pm.stacked_layer(mk)
            picked = pm.int8_arm(m, lp)
            for arm in dict.fromkeys((picked, "dp4a")):  # the picked arm, dp4a beside it
                ops = pm.prepare_int8(x, lp, pm.layout_of(arm))
                record("pb_int8_matmul_stacked", p, m, pm.launch_int8_stacked(ops, mk, arm),
                       pm.pb_int8_matmul_stacked_plain(x, mk),
                       lambda: pm.launch_int8_stacked(ops, mk, arm),
                       lambda: pm.pb_int8_matmul_stacked(x, mk),
                       lambda: pm.pb_int8_matmul_stacked_plain(x, mk), lambda: xb @ wb, True,
                       flat_kernel_equal=torch.equal(pm.launch_int8_stacked(ops, mk, arm),
                                                     pm.launch_int8(ops, lp, arm)),
                       arm=arm, picked=arm == picked,
                       flat_ms=timer(lambda: pm.launch_int8(ops, lp, arm)))
            for arm in pm.F32_ARMS:  # every arm of the stacked entry, beside the flat arm
                prep = functools.partial(pm.prepare_f32_arm, x, lp, arm)
                flat = pm.launch_f32
                ops = prep()
                record("pb_f32_matmul_stacked", p, m, pm.launch_f32_stacked(ops, mk),
                       pm.pb_f32_matmul_stacked_plain(x, mk),
                       lambda: pm.launch_f32_stacked(ops, mk),
                       lambda: pm.pb_f32_matmul_stacked(x, mk),
                       lambda: pm.pb_f32_matmul_stacked_plain(x, mk), lambda: x @ w, False,
                       flat_kernel_equal=torch.equal(pm.launch_f32_stacked(ops, mk),
                                                     flat(ops, lp)),
                       arm=arm, picked=pm.f32_arm(m, lp) == arm,
                       flat_ms=timer(lambda: flat(ops, lp)), prep_ms=timer(prep),
                       tensor_cores_bound_ms=f32_bounds(p, m, matmul_bytes(p, m))[1][0],
                       tensor_cores_bound_by=f32_bounds(p, m, matmul_bytes(p, m))[1][1])
            del ops, lp
        del layers, p, sp, mk, w, wb
    if not all(r.get("flat_kernel_equal", True) for r in rows):
        raise AssertionError("a stacked kernel differs from its flat kernel on the same layer")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the same engine on the card and on the CPU
# ---------------------------------------------------------------------------

def opt13b(layers: int):
    """`facebook/opt-1.3b`'s published config, cut to ``layers`` layers."""
    from pb_llm_tpu_torch.models.opt import OPTConfig

    return OPTConfig(vocab_size=50272, hidden_size=2048, ffn_dim=8192, num_hidden_layers=layers,
                     num_attention_heads=32, max_position_embeddings=2048)


def llama7b(layers: int):
    from pb_llm_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                       num_hidden_layers=layers, num_attention_heads=32,
                       max_position_embeddings=2048)


def run_parity(params, cfg, device, family: str = "llama", shared: int = 0,
               buckets=(64, 256), **ecfg_kw):
    """Prefill logits, 8 greedy tokens and a teacher-forced NLL on one engine:
    prefills of 40 and 70 tokens (by default in buckets of 64 and 256), 7
    decode steps and 3 teacher-forced ones, over 2 slots.  ``shared``: the
    second prompt starts with the first one's first ``shared`` tokens (a
    prefix-cache hit)."""
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    eng = Engine(params, cfg, family_for(family),
                 EngineConfig(n_slots=2, max_seq=256, prefill_buckets=buckets, **ecfg_kw),
                 device=device)
    rng = np.random.default_rng(3)
    first = rng.integers(0, cfg.vocab_size, 40).tolist()
    toks = [eng.prefill(0, first)]
    logits = eng._prefill_logits[0].float().cpu()
    toks += [eng.decode_step()[0] for _ in range(7)]
    second = rng.integers(0, cfg.vocab_size, 70).tolist()
    eng.prefill(1, first[:shared] + second[shared:])
    nll = eng.forced_decode_nll(1, rng.integers(0, cfg.vocab_size, 4).tolist())
    return logits, toks, nll


def check_engine_parity(params, arms: str, page_size: int = 0):
    """``arms`` "int8": the serving defaults; "exact": decode_dot f32 and
    the hybrid prefill, whose f32 matmul launches on the card are counted by
    arm (decode's 8 rows on the CUDA cores, prefill windows below 256 rows
    on the tensor cores).
    ``page_size``: the paged int8 pool instead of int8 strips (phase 6a),
    whose paged-attention launches on the card are counted."""
    from pb_llm_tpu_torch.ops import packed_matmul as pm
    from pb_llm_tpu_torch.ops import paged_attention as pa
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig

    cfg = llama7b(2)
    arm_kw = (dict(decode_dot="int8", prefill="int8") if arms == "int8"
              else dict(decode_dot="f32", prefill="hybrid"))
    card_kernels = None if arms == "int8" else KernelConfig(**arm_kw)
    pm.f32_launches = pm.f32_tc_launches = pm.f32_split_launches = pa.launches = 0
    t0 = time.perf_counter()
    g_logits, g_toks, g_nll = run_parity(params, cfg, DEV, kernels=card_kernels,
                                         page_size=page_size)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    f32_launches = {"cores": pm.f32_launches, "tc": pm.f32_tc_launches,
                    "split": pm.f32_split_launches}
    paged_launches = pa.launches
    plain = KernelConfig(backend="pallas_interpret", decode_attention="pallas_interpret", **arm_kw)
    t0 = time.perf_counter()
    c_logits, c_toks, c_nll = run_parity(params, cfg, "cpu", cache_dtype=torch.int8, kernels=plain,
                                         page_size=page_size)
    cpu_s = time.perf_counter() - t0
    scale = c_logits.abs().max().item()
    err = (g_logits - c_logits).abs().max().item()
    tol = LOGIT_TOL if arms == "int8" else LOGIT_TOL_EXACT
    row = {"phase": "engine_parity", "arms": arms, "page_size": page_size, "layers": 2,
           "paged_attention_launches": paged_launches, "max_abs_logit_err": err,
           "max_abs_logit": scale, "err_over_max_logit": err / scale, "tol_over_max_logit": tol,
           "gpu_tokens": g_toks, "cpu_tokens": c_toks, "gpu_nll": g_nll, "cpu_nll": c_nll,
           "f32_matmul_launches": f32_launches, "gpu_s": gpu_s, "cpu_s": cpu_s}
    log(json.dumps(row))
    if not (np.isfinite(g_nll) and torch.isfinite(g_logits).all()):
        raise AssertionError(f"engine parity ({arms}): non-finite GPU output")
    if err > tol * scale:
        raise AssertionError(f"engine parity ({arms}): logits differ by {err} > {tol} * {scale}")
    if g_toks != c_toks:
        raise AssertionError(f"engine parity ({arms}): greedy tokens differ {g_toks} vs {c_toks}")
    if abs(g_nll - c_nll) > NLL_RTOL * abs(c_nll):
        raise AssertionError(f"engine parity ({arms}): NLL {g_nll} vs {c_nll}")
    if arms == "exact" and not (f32_launches["split"] and f32_launches["tc"]):
        raise AssertionError(f"engine parity (exact): an f32 matmul arm never launched "
                             f"{f32_launches}")
    if page_size and paged_launches == 0:
        raise AssertionError("engine parity (paged): the paged-attention kernel never launched")
    return row


# ---------------------------------------------------------------------------
# phase 4: end to end
# ---------------------------------------------------------------------------

def packed_bytes(p) -> int:
    return sum(t.numel() * t.element_size() for t in
               (p.sign_packed, p.side_val, p.side_idx, p.low_scale, p.low_mean,
                p.high_scale, p.high_zero))


def count_forwards(eng, on_forward, forward_ms=None):
    """Route each forward of ``eng`` through ``on_forward(kind, rows, caches,
    pos, logits)``: ``_forward`` runs prefills, chunk and prefix-suffix
    windows and speculative verifies, ``_step_logits`` the decode steps
    (graphed or eager).  With a list ``forward_ms``, each ``_forward`` runs
    between two device synchronisations and its wall ms is appended before
    ``on_forward`` sees it.  Returns a function that restores the methods."""
    fwd, step = eng._forward, eng._step_logits

    def counted_forward(ids, caches, pos):
        if forward_ms is not None:
            torch.cuda.synchronize()
            t = time.perf_counter()
        logits = fwd(ids, caches, pos)
        if forward_ms is not None:
            torch.cuda.synchronize()
            forward_ms.append((time.perf_counter() - t) * 1e3)
        on_forward(None, int(np.asarray(ids).size), caches, pos, logits)
        return logits

    def counted_step():
        logits = step()
        on_forward("decode", eng.ecfg.n_slots, None, None, logits)
        return logits

    eng._forward, eng._step_logits = counted_forward, counted_step

    def restore():
        del eng._forward, eng._step_logits  # the class's methods again

    return restore


INT8_COUNTERS = {"dp4a": "pb_int8_matmul", "tc": "pb_int8_matmul_tc",
                 "split": "pb_int8_matmul_split"}


def int8_launches(rows, n_linear: int, p, kernel: str = "pb_int8_matmul") -> dict:
    """The int8 matmul's launches by arm for forwards of ``rows`` rows each,
    ``n_linear`` packed linears a forward, under `packed_matmul.int8_arm`'s
    rule on layer ``p`` (llama-7b's linears all take the tensor cores: "tc"
    from M_TC rows on, DECODE_ARM below); ``kernel`` the entry's counter
    prefix ("pb_int8_matmul_stacked" for the stacked entry)."""
    from pb_llm_tpu_torch.ops import packed_matmul as pm

    out = {c.replace("pb_int8_matmul", kernel): 0 for c in INT8_COUNTERS.values()}
    for r in rows:
        out[INT8_COUNTERS[pm.int8_arm(r, p)].replace("pb_int8_matmul", kernel)] += n_linear
    return out


def paged_split(cfg) -> bool:
    """Whether paged decode takes the arm "split" for ``cfg``'s heads (the
    wrapper's rule, `paged_attention.window_arm`)."""
    from pb_llm_tpu_torch.ops import paged_attention as tpa

    g = cfg.num_attention_heads // cfg.kv_heads
    return tpa.window_arm(1, torch.int8, g, cfg.head_dim) == tpa.SPLIT


def attention_launches(n: int) -> dict:
    """The strip decode attention's counters for ``n`` launches of its
    default arm, "split"."""
    return {"decode_attention": n, "decode_attention_split": n}


def pair_launches(rows, n_linear: int, p) -> dict:
    """The pair kernel's launches by arm for forwards of ``rows`` rows each
    (all below 256), ``n_linear`` packed linears a forward, under
    `decode_arms.pair_arm`'s rule on layer ``p`` (llama-7b's linears, fused
    or not, all take the tensor-core code)."""
    from pb_llm_tpu_torch.ops import decode_arms as da

    names = {"mma": "pb_pair_v2", "split": "pb_pair_v2_split", "tc": "pb_pair_v2_tc"}
    out = {k: 0 for k in names.values()}
    for r in rows:
        out[names[da.pair_arm(r, p)]] += n_linear
    return out


def dma_launches(rows, n_linear: int, p) -> dict:
    """The dma kernel's launches by arm for forwards of ``rows`` rows each
    (all below 256), ``n_linear`` packed linears a forward, under
    `decode_arms.dma_arm`'s rule on layer ``p``: arm "split" also launches
    its x preparation once a linear."""
    from pb_llm_tpu_torch.ops import decode_arms as da

    n = n_linear * len(rows)
    if da.dma_arm(p) == "split":
        return {"pb_dma_v2": 0, "pb_dma_v2_split": n, "pb_prep_dma": n}
    return {"pb_dma_v2": n, "pb_dma_v2_split": 0, "pb_prep_dma": 0}


def first_linear(params):
    """A packed linear of the model: the layout the arm rule reads."""
    return next(v for v in params["layers"][0].values() if hasattr(v, "sign_packed"))


def run_counted(eng, reqs):
    """Serve ``reqs`` through `ContinuousBatcher` on ``eng`` after one short
    warm-up request (the first forward initialises cuBLAS and the
    allocator), with the launch counters zeroed just before and read just
    after.  Returns (batcher, launches, forwards, step_ms, kv_rows,
    prefill_ms): ``forwards`` holds (kind, rows) of each forward, kind
    "prefill" or "decode"; ``step_ms`` each decode step's time (device
    synchronised); ``kv_rows`` the KV rows each step attends;
    ``prefill_ms`` each prefill forward's time (device synchronised).
    Raises on non-finite logits or a request short of its tokens."""
    from pb_llm_tpu_torch.runtime.batching import ContinuousBatcher, Request

    ContinuousBatcher(eng).run([Request(request_id=-1, prompt_ids=[1, 2, 3], max_new_tokens=2)])
    forwards, step_ms, kv_rows = [], [], []
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    step = eng.decode_step

    def on_forward(kind, rows, caches, pos, logits):
        nonlocal finite
        forwards.append((kind or "prefill", rows))
        finite = finite & torch.isfinite(logits).all()

    def timed_step():
        kv_rows.append(int(eng.lengths.sum()) + eng.ecfg.n_slots)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    prefill_ms = []
    restore = count_forwards(eng, on_forward, prefill_ms)
    eng.decode_step = timed_step
    batcher = ContinuousBatcher(eng)
    zero_counters()
    batcher.run(reqs)
    torch.cuda.synchronize()
    launches = read_counters()
    restore()
    del eng.decode_step
    if not bool(finite):
        raise AssertionError("e2e: non-finite logits")
    if not all(r.done and len(r.output_ids) == r.max_new_tokens for r in reqs):
        raise AssertionError("e2e: a request did not produce its tokens")
    return batcher, launches, forwards, step_ms, kv_rows, prefill_ms


def e2e_requests(vocab: int):
    """Phases 4 and 7b's mix: 16 requests of 20–120 random tokens, 32 new
    tokens each."""
    from pb_llm_tpu_torch.runtime.batching import Request

    rng = np.random.default_rng(6)
    return [Request(request_id=i, max_new_tokens=E2E_NEW,
                    prompt_ids=rng.integers(0, vocab, int(rng.integers(20, 121))).tolist())
            for i in range(16)]


def replay_ms(eng, iters: int = 20) -> float:
    """Median device time of one replay of ``eng``'s decode-step graph (CUDA
    events; the step's inputs as the last step left them)."""
    g = eng._step.graph
    g.replay()
    pairs = []
    for _ in range(iters):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def serve_e2e(params, build_s: float, card: str, profile: bool):
    """Phase 4: the same engine serves the same 16 requests twice, first
    under `step_graph.eager()` (the decode step op by op), then graphed
    (the default on the card).  Returns the graphed pass's row."""
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.runtime import step_graph
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg = llama7b(32)
    eng = Engine(params, cfg, family_for("llama"), EngineConfig(n_slots=8, max_seq=2048),
                 device=DEV)
    n_linear = sum(1 for lp in params["layers"] for v in lp.values() if hasattr(v, "sign_packed"))
    plane_bytes = sum(packed_bytes(v) for lp in params["layers"] for v in lp.values()
                      if hasattr(v, "sign_packed"))
    head_bytes = params["lm_head"]["w"].numel() * 4
    assert eng.cache_dtype == torch.int8 and n_linear == 7 * cfg.num_hidden_layers
    kv_row_bytes = cfg.num_hidden_layers * cfg.kv_heads * (2 * cfg.head_dim + 8)

    rows = {}
    for mode in ("eager", "graph"):
        reqs = e2e_requests(cfg.vocab_size)
        with step_graph.eager() if mode == "eager" else contextlib.nullcontext():
            batcher, launches, fwds, step_ms, kv_rows, prefill_ms = run_counted(eng, reqs)
        forwards = {kind: sum(k == kind for k, _ in fwds) for kind in ("prefill", "decode")}
        by_arm = int8_launches([m for _, m in fwds], n_linear, first_linear(params))
        mm, att = sum(by_arm.values()), launches["decode_attention"]
        if mm != n_linear * (forwards["prefill"] + forwards["decode"]) or mm == 0:
            raise AssertionError(f"e2e ({mode}): {mm} matmul launches for {forwards} forwards")
        if att != cfg.num_hidden_layers * forwards["decode"] or att == 0:
            raise AssertionError(f"e2e ({mode}): {att} attention launches for {forwards} forwards")
        if launches != expect_launches(**by_arm, pb_prep_int8=mm, **attention_launches(att)):
            raise AssertionError(f"e2e ({mode}): launches {launches}, expected the int8 arms "
                                 f"{by_arm} by rows (M_TC), {mm} x preparations and {att} "
                                 f"attentions, nothing else")
        mean_rows = statistics.mean(kv_rows)
        s = batcher.stats
        row = {"phase": "e2e", "mode": mode,
               "model": "llama-7b PBW-v2 (random planes, low_frac 0.9)",
               "layers": cfg.num_hidden_layers, "slots": 8, "max_seq": 2048,
               "requests": len(reqs), "generated_tokens": s.generated_tokens,
               "wall_s": s.wall_seconds, "tokens_per_s": s.tokens_per_second,
               "decode_steps": len(step_ms), "ms_per_decode_step_median": statistics.median(step_ms),
               "ms_per_decode_step_mean": statistics.mean(step_ms),
               "prefill_forwards": forwards["prefill"], "decode_forwards": forwards["decode"],
               "prefill_ms_total": sum(prefill_ms),
               "prefill_rows": sorted(m for k, m in fwds if k == "prefill"),
               "matmul_launches": mm, "matmul_launches_by_arm": by_arm,
               "prep_launches": launches["pb_prep_int8"],
               "attention_launches": att,
               "attention_split_launches": launches["decode_attention_split"],
               "matmul_launches_per_decode_step": n_linear,
               "attention_launches_per_decode_step": cfg.num_hidden_layers,
               "packed_plane_bytes": plane_bytes, "lm_head_bytes": head_bytes,
               "mean_kv_rows_per_step": mean_rows,
               "decode_step_bound_ms": (plane_bytes + head_bytes + mean_rows * kv_row_bytes)
               / HBM_BYTES_PER_S * 1e3,
               "graph_replays": eng._step.replays, "build_s": build_s,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
        if mode == "graph":
            row["graph_replay_device_ms"] = replay_ms(eng)
            row["graph_idle_share"] = 1 - row["graph_replay_device_ms"] / row[
                "ms_per_decode_step_median"]
            row["tokens_per_s_over_eager"] = row["tokens_per_s"] / rows["eager"]["tokens_per_s"]
            row["step_median_over_eager"] = (row["ms_per_decode_step_median"]
                                             / rows["eager"]["ms_per_decode_step_median"])
        log(json.dumps(row))
        rows[mode] = row
    if rows["graph"]["graph_replays"] == 0:
        raise AssertionError("e2e: the graphed pass replayed no graph")
    if profile:
        for mode in ("eager", "graph"):
            profile_decode(eng, mode)
    return rows["graph"]


def profile_decode(eng, mode: str) -> None:
    """Device time by kernel over three decode steps of the full pool
    (`torch.profiler`), and the share of an unprofiled step the device sits
    idle; ``mode`` "eager" runs the steps under `step_graph.eager()`.  For
    the graph, the replay's device time (CUDA events) stands beside the
    trace's sum."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from pb_llm_tpu_torch.runtime import step_graph

    with step_graph.eager() if mode == "eager" else contextlib.nullcontext():
        for slot in range(eng.ecfg.n_slots):
            eng.prefill(slot, list(range(1, 101)))
        eng.decode_step()
        eng.decode_step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            eng.decode_step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3 / 3
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                eng.decode_step()
            torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:  # kernels and copies on the card
            us, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3 / 3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    row = {"phase": "profile", "mode": mode, "steps": 3, "ctx": 100, "step_ms": step_ms,
           "device_busy_ms_per_step": busy_ms if busy_ms else "not measured",
           "device_idle_share": (1 - busy_ms / step_ms) if busy_ms else "not measured",
           "top": [{"name": k[:80], "device_ms_per_step": us / 3e3, "launches_per_step": c / 3}
                   for k, (us, c) in top]}
    if mode == "graph":
        row["graph_replay_device_ms"] = replay_ms(eng)
        row["idle_share_from_replay"] = 1 - row["graph_replay_device_ms"] / step_ms
    log(json.dumps(row))
    for slot in range(eng.ecfg.n_slots):
        eng.release(slot)


# ---------------------------------------------------------------------------
# phase 5: the producer
# ---------------------------------------------------------------------------

def zero_counters() -> None:
    from pb_llm_tpu_torch.ops import counters

    counters.zero()


def read_counters() -> dict:
    """Every kernel's launches by kind (`ops.counters.KERNELS`)."""
    from pb_llm_tpu_torch.ops import counters

    return counters.read()


def expect_launches(**counts) -> dict:
    """read_counters()'s keys, each 0 unless given."""
    return {k: counts.get(k, 0) for k in read_counters()}


def compare_solves(w, h, scfg, metrics=("magnitude", "hessian")):
    """One linear's GPTQ-PB solve on the card and on the CPU from the same
    (W, H): magnitude masks must be identical; hessian masks depend on
    diag(Hinv) from two Cholesky factorizations, so near-ties may flip (the
    count of differing columns is reported)."""
    import dataclasses

    from pb_llm_tpu_torch.calib.solver import gptq_pb

    out = {}
    for metric in metrics:
        cfg = dataclasses.replace(scfg, salient_metric=metric)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = gptq_pb(w, h, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        c = gptq_pb(w.cpu(), h.cpu(), cfg)
        t2 = time.perf_counter()
        g_mask = g["mask"].cpu()
        cols = (g_mask != c["mask"]).any(dim=0)
        wq = c["w_q"]
        out[metric] = {"mask_cols_differing": int(cols.sum()), "ic": int(w.shape[1]),
                       "w_q_rel_diff": float((g["w_q"].cpu() - wq).norm() / wq.norm()),
                       "error_gpu": float(g["error"]), "error_cpu": float(c["error"]),
                       "gpu_s": t1 - t0, "cpu_s": t2 - t1}
    if out.get("magnitude", {}).get("mask_cols_differing"):
        raise AssertionError(f"producer: magnitude masks differ between card and CPU: {out}")
    return out


def producer(card: str):
    """run_ptq's path at llama-7b's width (2 layers): synthetic calibration
    windows, GPTQ-PB with the reference sweep's settings (xnor, low_frac
    0.9, hessian saliency, 8-bit salient codes) into PBW v2, then windowed
    perplexity under the exact hybrid prefill (`pin_exact_prefill`)."""
    from pb_llm_tpu_torch.calib.hessian import fold_coefficients, hessian_fold_chunk
    from pb_llm_tpu_torch.calib.pipeline import quantize_model_ptq
    from pb_llm_tpu_torch.calib.solver import SolverConfig
    from pb_llm_tpu_torch.core.pbw import PackedLinearV2
    from pb_llm_tpu_torch.data.loaders import get_loaders
    from pb_llm_tpu_torch.data.synthetic import ByteTokenizer, synthetic_source
    from pb_llm_tpu_torch.eval.ppl import perplexity
    from pb_llm_tpu_torch.models.llama import init_params, rms_norm
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops import kernel_config as kc

    cfg = llama7b(2)
    fam = family_for("llama")
    tok, source = ByteTokenizer(), synthetic_source()
    calib, _ = get_loaders("wikitext2", tok, nsamples=PTQ_NSAMPLES, seed=0, seqlen=PTQ_SEQLEN,
                           flavor="ptq", source=source)
    _, evaltok = get_loaders("wikitext2", tok, nsamples=2, seed=0, seqlen=PTQ_SEQLEN, flavor="ptq",
                             source=source)
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(10), device=DEV)
    scfg = SolverConfig(low_method="xnor", low_frac=0.9, high_bit=8, salient_metric="hessian",
                        mask_structure="column")

    # layer 0's q_proj input Hessian, for the card-vs-CPU solve below
    lp0 = params["layers"][0]
    with torch.inference_mode():
        x0 = rms_norm(params["embed_tokens"][torch.as_tensor(calib, device=DEV)],
                      lp0["input_layernorm"], cfg.rms_norm_eps)
        h0 = hessian_fold_chunk(torch.zeros((cfg.hidden_size,) * 2, device=DEV), x0,
                                *fold_coefficients(0, PTQ_NSAMPLES))
        w0 = lp0["q_proj"]["w"].T.contiguous()
    del x0

    kc.pin_exact_prefill()  # as run_ptq / run_eval do
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    params, report = quantize_model_ptq(params, cfg, fam, calib, scfg, fmt="packed_v2", log=None,
                                        capture_batch=PTQ_NSAMPLES)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ppl = perplexity(params, cfg, fam.forward, evaltok, seqlen=PTQ_SEQLEN,
                     window_limit=PPL_WINDOWS, window_batch=PPL_BATCH)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    plain = kc.KernelConfig(backend="pallas_interpret", prefill="hybrid", attention="flash_interpret")
    with kc.use_kernels(plain):
        ppl_plain = perplexity(params, cfg, fam.forward, evaltok, seqlen=PTQ_SEQLEN,
                               window_limit=PPL_WINDOWS, window_batch=PPL_BATCH)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    if read_counters() != launches:
        raise AssertionError("producer: the plain-version perplexity launched a kernel")
    solves = compare_solves(w0, h0, scfg)
    # the same solve from a well-conditioned H (Gaussian inputs): the byte
    # corpus has few distinct tokens, so layer 0's H has tiny rank and the
    # error feedback amplifies the two devices' f32 rounding differences
    xg = torch.randn((2 * cfg.hidden_size, cfg.hidden_size),
                     generator=torch.Generator(device=DEV).manual_seed(11), device=DEV)
    solves["gaussian_h"] = compare_solves(w0, (2.0 / xg.shape[0]) * (xg.T @ xg), scfg,
                                          metrics=("hessian",))["hessian"]
    del xg

    n_packed = sum(isinstance(v, PackedLinearV2) for lp in params["layers"] for v in lp.values())
    forwards = -(-PPL_WINDOWS // PPL_BATCH)
    chunks = 1  # capture_batch == nsamples: one calibration chunk per layer
    want = expect_launches(pb_dequant_v2=n_packed * (chunks + forwards),
                           flash_attention_tc=cfg.num_hidden_layers * (2 * chunks + forwards))
    row = {"phase": "producer", "model": "llama-7b widths, 2 layers, random-init f32 weights",
           "calib": f"synthetic wikitext2 (ptq flavor), {PTQ_NSAMPLES} x {PTQ_SEQLEN}",
           "calib_distinct_tokens": int(np.unique(calib).size),
           "solver": "xnor low_frac 0.9 hessian high_bit 8, column masks, packed_v2",
           "ppl_windows": PPL_WINDOWS, "ppl_batch": PPL_BATCH, "ppl": ppl, "ppl_plain": ppl_plain,
           "ppl_rel_diff": abs(ppl - ppl_plain) / ppl_plain, "quantize_s": t1 - t0,
           "ppl_s": t2 - t1, "ppl_plain_s": t3 - t2, "layer_seconds": report.layer_seconds,
           "layer_output_mse": report.layer_output_mse, "total_gptq_error": sum(report.errors.values()),
           "packed_linears": n_packed, "launches": launches, "peak_mem_gb": peak_gb,
           "q_proj_card_vs_cpu": solves, "card": card}
    log(json.dumps(row))
    if n_packed != 7 * cfg.num_hidden_layers:
        raise AssertionError(f"producer: {n_packed} packed linears")
    if not (np.isfinite(ppl) and np.isfinite(ppl_plain)):
        raise AssertionError(f"producer: perplexity {ppl} / {ppl_plain}")
    if abs(ppl - ppl_plain) > PPL_RTOL * ppl_plain:
        raise AssertionError(f"producer: ppl {ppl} (kernels) vs {ppl_plain} (plain versions)")
    if launches != want:
        raise AssertionError(f"producer: launches {launches}, expected {want}")
    return row


# ---------------------------------------------------------------------------
# phase 6a: paged serving invariants
# ---------------------------------------------------------------------------

def serve_streams(params, cfg, prompts, draft_source=None, **ecfg_kw):
    """Greedy streams of ``prompts`` (INV_NEW tokens each) through
    ContinuousBatcher on the card, f32 KV unless told otherwise."""
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig
    from pb_llm_tpu_torch.runtime.batching import ContinuousBatcher, Request
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    kw = dict(INV_ECFG, cache_dtype=torch.float32, kernels=KernelConfig(**INV_ARMS)) | ecfg_kw
    eng = Engine(params, cfg, family_for("llama"), EngineConfig(**kw), device=DEV)
    batcher = ContinuousBatcher(eng, draft_source=draft_source)
    reqs = [Request(request_id=i, prompt_ids=list(p), max_new_tokens=INV_NEW)
            for i, p in enumerate(prompts)]
    batcher.run(reqs)
    if not all(r.done and len(r.output_ids) == INV_NEW for r in reqs):
        raise AssertionError(f"invariants {ecfg_kw}: a request did not produce its tokens")
    return [r.output_ids for r in reqs], batcher


def hold_streams(params, cfg, what: str, prompts, want, got) -> dict:
    """``got`` must equal ``want`` (the reference run) request by request,
    but for near-ties: at a request's first differing token the reference
    run's two highest logits, re-scored by a one-shot strip prefill of its
    own prefix, must lie within MARGIN of max|logit|.  Each such case is
    printed; any other difference fails the run."""
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    ties = []
    for i, (w, g) in enumerate(zip(want, got)):
        if w == g:
            continue
        k = next(j for j, (a, b) in enumerate(zip(w, g)) if a != b)
        ref = Engine(params, cfg, family_for("llama"),
                     EngineConfig(n_slots=1, max_seq=2048, prefill_buckets=(1024, 2048),
                                  cache_dtype=torch.float32, kernels=KernelConfig(**INV_ARMS)),
                     device=DEV)
        ref.prefill(0, list(prompts[i]) + w[:k])
        logits = ref._prefill_logits[0].float()
        top2 = torch.topk(logits, 2).values
        gap, scale = float(top2[0] - top2[1]), float(logits.abs().max())
        tie = {"check": what, "request": i, "first_diff": k, "want": w[k], "got": g[k],
               "top2_gap": gap, "max_abs_logit": scale, "gap_over_max": gap / scale}
        log(json.dumps({"phase": "invariants_near_tie", **tie}))
        if gap > MARGIN * scale:
            raise AssertionError(f"invariants ({what}): request {i} differs at token {k} with a "
                                 f"top-2 gap of {gap} > {MARGIN} * {scale}")
        ties.append(tie)
        del ref
    return {"check": what, "requests": len(want), "equal": sum(w == g for w, g in zip(want, got)),
            "near_ties": len(ties)}


def paged_invariants(params, card: str):
    """The JAX package's serving invariants at full width on the card: 2
    layers of random PBW-v2 planes, the exact matmul arms (INV_ARMS), pages
    of 16."""
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig
    from pb_llm_tpu_torch.runtime.draft import ModelDraftSource
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    from pb_llm_tpu_torch.interop import to_device

    cfg = llama7b(2)
    params = to_device(params, DEV)  # once, not for each engine
    v = cfg.vocab_size
    rng = np.random.default_rng(14)

    def rand(lo, hi):
        return rng.integers(0, v, int(rng.integers(lo, hi + 1))).tolist()

    short = [rand(20, 120) for _ in range(8)]
    prefix = rng.integers(0, v, 96).tolist()
    shared = [prefix + rand(20, 120) for _ in range(4)] + short[:4]
    long = [rand(600, 1000) for _ in range(8)]
    tight = [rand(116, 124) for _ in range(8)]  # all cross a page of 128 while decoding
    t0 = time.perf_counter()
    out = []
    strip, _ = serve_streams(params, cfg, short)
    paged, _ = serve_streams(params, cfg, short, page_size=16)
    out.append(hold_streams(params, cfg, "paged vs strip", short, strip, paged))
    off, _ = serve_streams(params, cfg, shared, page_size=16)
    on, b_on = serve_streams(params, cfg, shared, page_size=16, prefix_cache=True)
    out.append(hold_streams(params, cfg, "prefix cache on vs off", shared, off, on))
    hits = b_on.engine.pool.prefix_hit_pages
    one, _ = serve_streams(params, cfg, long, page_size=16)
    chunked, _ = serve_streams(params, cfg, long, page_size=16, prefill_chunk=256)
    out.append(hold_streams(params, cfg, "prefill_chunk 256 vs one-shot", long, one, chunked))
    spec, b_spec = serve_streams(params, cfg, short, page_size=16, spec_gamma=4)
    out.append(hold_streams(params, cfg, "spec_gamma 4 vs plain", short, paged, spec))
    ample, _ = serve_streams(params, cfg, tight, page_size=16)
    small, b_small = serve_streams(params, cfg, tight, page_size=16, n_pages=34)
    out.append(hold_streams(params, cfg, "34 pages (preempting) vs ample", tight, ample, small))
    draft = ModelDraftSource(Engine(params, cfg, family_for("llama"),
                                    EngineConfig(**INV_ECFG, cache_dtype=torch.float32,
                                                 kernels=KernelConfig(**INV_ARMS)), device=DEV))
    selfd, b_self = serve_streams(params, cfg, short, draft_source=draft, page_size=16,
                                  spec_gamma=4)
    out.append(hold_streams(params, cfg, "self-draft spec vs plain", short, paged, selfd))
    accept = b_self.stats.spec_accepted / max(b_self.stats.spec_drafted, 1)
    torch.cuda.synchronize()
    row = {"phase": "paged_invariants", "layers": 2, "page_size": 16, "arms": INV_ARMS,
           "checks": out,
           "prefix_hit_pages": hits, "preemptions": b_small.stats.preemptions,
           "spec_prompt_lookup_accept": b_spec.stats.spec_accepted
           / max(b_spec.stats.spec_drafted, 1), "self_draft_accept": accept,
           "seconds": time.perf_counter() - t0, "card": card}
    log(json.dumps(row))
    if hits == 0:
        raise AssertionError("invariants: the prefix cache never hit")
    if b_small.stats.preemptions == 0:
        raise AssertionError("invariants: the small pool never preempted")
    if accept < SELF_DRAFT_ACCEPT:
        raise AssertionError(f"invariants: self-draft acceptance {accept} < {SELF_DRAFT_ACCEPT}")
    return row


# ---------------------------------------------------------------------------
# phase 6b: paged serving end to end
# ---------------------------------------------------------------------------

def paged_prompts(v: int):
    """Phase 6b's 16 prompts: 8 sharing a 96-token prefix, 4 of 600-1000
    tokens (longer than a chunk), 4 of 8-32."""
    rng = np.random.default_rng(15)

    def rand(lo, hi):
        return rng.integers(0, v, int(rng.integers(lo, hi + 1))).tolist()

    prefix = rng.integers(0, v, 96).tolist()
    shared = [prefix + rand(20, 120) for _ in range(8)]
    long = [rand(600, 1000) for _ in range(4)]   # longer than a chunk: the chunked path
    short = [rand(8, 32) for _ in range(4)]
    prompts = []
    for i in range(4):
        prompts += [shared[2 * i], long[i], short[i], shared[2 * i + 1]]
    return prompts


def paged_requests(v: int):
    """Phase 6b's mix as requests: its prompts, E2E_NEW new tokens each."""
    from pb_llm_tpu_torch.runtime.batching import Request

    return [Request(request_id=i, prompt_ids=p, max_new_tokens=E2E_NEW)
            for i, p in enumerate(paged_prompts(v))]


def paged_e2e(params, card: str):
    """The 32-layer llama-7b of phase 4 behind `EngineConfig(n_slots=8,
    max_seq=2048, page_size=16, prefix_cache=True, prefill_chunk=256)`, int8
    pages: the same 16 requests on a fresh engine with plain decode (the
    t = 1 kernel), then with spec_gamma 4 (every tick a t = 5 verify)."""
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.runtime.batching import ContinuousBatcher, Request
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg = llama7b(32)
    prompts = paged_prompts(cfg.vocab_size)
    n_linear, n_layers = 7 * cfg.num_hidden_layers, cfg.num_hidden_layers
    rows = []
    for gamma in (0, 4):
        eng = Engine(params, cfg, family_for("llama"),
                     EngineConfig(n_slots=8, max_seq=2048, page_size=16, prefix_cache=True,
                                  prefill_chunk=256, spec_gamma=gamma), device=DEV)
        assert eng.cache_dtype == torch.int8 and eng.pool.n_pages == 1024
        pool_bytes = sum(t.numel() * t.element_size() for c in eng.caches
                         for k, t in c.items() if k != "table")
        ContinuousBatcher(eng).run([Request(request_id=-1, prompt_ids=[1, 2, 3],
                                            max_new_tokens=2)])  # cuBLAS, allocator
        forwards = {"prefill": 0, "decode": 0, "verify": 0, "window": 0}
        finite = torch.ones((), dtype=torch.bool, device=DEV)
        step_ms, chunk_steps, fwd_rows, fwd_ms, prefill_ms = [], [0], [], [], []
        dec, spec, chunk = eng.decode_step, eng.spec_decode_step, eng.prefill_chunk_step

        def on_forward(kind, rows, caches, pos, logits):
            nonlocal finite
            if kind is None:
                if "chunk_table" in caches[0]:
                    kind = "window"  # a chunk or a prefix-cache suffix
                else:
                    kind = "verify" if isinstance(pos, torch.Tensor) else "prefill"
                if kind != "verify":
                    prefill_ms.append(fwd_ms[-1])
            forwards[kind] += 1
            fwd_rows.append(rows)
            finite = finite & torch.isfinite(logits).all()

        def timed(fn):
            def run(*a):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a)
                torch.cuda.synchronize()
                if out:  # a tick with no decoding slot runs no forward
                    step_ms.append((time.perf_counter() - t) * 1e3)
                return out
            return run

        def counted_chunk(slot):
            chunk_steps[0] += 1
            return chunk(slot)

        restore = count_forwards(eng, on_forward, fwd_ms)
        eng.prefill_chunk_step = counted_chunk
        eng.decode_step, eng.spec_decode_step = timed(dec), timed(spec)
        reqs = [Request(request_id=i, prompt_ids=p, max_new_tokens=E2E_NEW)
                for i, p in enumerate(prompts)]
        batcher = ContinuousBatcher(eng)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hits0 = eng.pool.prefix_hit_pages
        zero_counters()
        batcher.run(reqs)
        torch.cuda.synchronize()
        launches = read_counters()
        s = batcher.stats
        n_fwd = sum(forwards.values())
        row = {"phase": "paged_e2e", "pass": 1 if gamma == 0 else 2, "spec_gamma": gamma,
               "model": "llama-7b PBW-v2 (random planes, low_frac 0.9)", "layers": n_layers,
               "slots": 8, "max_seq": 2048, "page_size": 16, "pages": eng.pool.n_pages + 1,
               "kv": "int8 pages", "requests": len(reqs), "generated_tokens": s.generated_tokens,
               "wall_s": s.wall_seconds, "tokens_per_s": s.tokens_per_second,
               "prefill_ms_total": sum(prefill_ms),
               "decode_steps": len(step_ms), "ms_per_step_median": statistics.median(step_ms),
               "ms_per_step_mean": statistics.mean(step_ms), "forwards": forwards,
               "chunk_steps": chunk_steps[0], "spec_drafted": s.spec_drafted,
               "spec_accepted": s.spec_accepted,
               "acceptance": s.spec_accepted / s.spec_drafted if s.spec_drafted else None,
               "prefix_hit_pages": eng.pool.prefix_hit_pages - hits0,
               "preemptions": s.preemptions, "pool_bytes": pool_bytes, "launches": launches,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
        log(json.dumps(row))
        restore()
        del eng.decode_step, eng.spec_decode_step, eng.prefill_chunk_step
        if not bool(finite):
            raise AssertionError(f"paged e2e pass {row['pass']}: non-finite logits")
        if not all(r.done and len(r.output_ids) == E2E_NEW for r in reqs):
            raise AssertionError(f"paged e2e pass {row['pass']}: a request lacks its tokens")
        windows = n_layers * (forwards["verify"] + forwards["window"])  # the tensor cores'
        want = expect_launches(
            **int8_launches(fwd_rows, n_linear, first_linear(params)),
            pb_prep_int8=n_linear * n_fwd,
            paged_attention_decode=n_layers * forwards["decode"],
            paged_attention_split=n_layers * forwards["decode"] * paged_split(cfg),
            paged_attention_multi=windows, paged_attention_window=windows)
        if launches != want:
            raise AssertionError(f"paged e2e pass {row['pass']}: launches {launches}, "
                                 f"expected {want} for {forwards}")
        if gamma == 0 and launches["paged_attention_decode"] == 0:
            raise AssertionError("paged e2e pass 1: the decode kernel never launched")
        if launches["paged_attention_multi"] == 0 or (gamma and forwards["verify"] == 0):
            raise AssertionError(f"paged e2e pass {row['pass']}: no multi-query launch")
        if row["prefix_hit_pages"] == 0 or chunk_steps[0] == 0:
            raise AssertionError(f"paged e2e pass {row['pass']}: no prefix hit or no chunk")
        rows.append(row)
        del eng, batcher
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 7a, 7b and 8: PBW v1 on the OPT family
# ---------------------------------------------------------------------------

def check_opt_parity(card: str):
    """Phase 7a: 2 layers of full-width OPT-1.3B, random PBW-v1 planes in
    groups of 128, random biases, int8 strips, on the card (kernels) and on
    the CPU (plain versions).  Neither matmul rounds x to int8, so the
    exact arms' logit bound holds.  run_parity's forwards take the planar
    kernel 11 times a linear (the 40-token prefill, 7 + 3 decode steps), on
    the arm `planar_arm` picks, and the select kernel once (the 70-token
    prefill in bucket 256), on the arm `select_arm` picks for 256 rows."""
    from pb_llm_tpu_torch.data.synthetic import random_packed_opt
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig
    from pb_llm_tpu_torch.ops.packed_matmul_v1 import planar_arm, select_arm

    cfg = opt13b(2)
    params = random_packed_opt(cfg, torch.Generator(device=DEV).manual_seed(16), groupsize=128)
    n_linear = 6 * cfg.num_hidden_layers
    zero_counters()
    t0 = time.perf_counter()
    g_logits, g_toks, g_nll = run_parity(params, cfg, DEV, family="opt")
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = read_counters()
    plain = KernelConfig(backend="pallas_interpret", decode_attention="pallas_interpret")
    t0 = time.perf_counter()
    c_logits, c_toks, c_nll = run_parity(params, cfg, "cpu", family="opt", cache_dtype=torch.int8,
                                         kernels=plain)
    cpu_s = time.perf_counter() - t0
    scale = c_logits.abs().max().item()
    err = (g_logits - c_logits).abs().max().item()
    row = {"phase": "opt_parity", "model": "OPT-1.3B widths, 2 layers, random PBW-v1 planes "
           "(groups of 128, low_frac 0.9) and biases", "kv": "int8 strips",
           "max_abs_logit_err": err, "max_abs_logit": scale, "err_over_max_logit": err / scale,
           "tol_over_max_logit": LOGIT_TOL_EXACT, "gpu_tokens": g_toks, "cpu_tokens": c_toks,
           "gpu_nll": g_nll, "cpu_nll": c_nll, "launches": launches, "gpu_s": gpu_s,
           "cpu_s": cpu_s, "card": card}
    log(json.dumps(row))
    if not (np.isfinite(g_nll) and torch.isfinite(g_logits).all()):
        raise AssertionError("OPT parity: non-finite GPU output")
    if err > LOGIT_TOL_EXACT * scale:
        raise AssertionError(f"OPT parity: logits differ by {err} > {LOGIT_TOL_EXACT} * {scale}")
    if g_toks != c_toks:
        raise AssertionError(f"OPT parity: greedy tokens differ {g_toks} vs {c_toks}")
    if abs(g_nll - c_nll) > NLL_RTOL * abs(c_nll):
        raise AssertionError(f"OPT parity: NLL {g_nll} vs {c_nll}")
    p = next(v for v in params["layers"][0].values() if hasattr(v, "sign_packed"))
    select = "pb_select_v1_tc" if select_arm(256, p) == "tc" else "pb_select_v1"
    want = expect_launches(**{PLANAR_COUNTERS[planar_arm(p)]: 11 * n_linear, select: n_linear},
                           **attention_launches(10 * cfg.num_hidden_layers))
    if launches != want:
        raise AssertionError(f"OPT parity: launches {launches}, expected {want}")
    return row


PLANAR_COUNTERS = {"cores": "pb_planar_v1", "tc": "pb_planar_v1_tc"}


def v1_launches(forwards, linears, n_layers: int) -> dict:
    """The launches a run of ``forwards`` (kind, rows) must show on PBW-v1
    linears: the planar arm `planar_arm` picks where `use_planar`, else the
    select arm `select_arm` picks, and one decode attention a layer a
    decode step."""
    from pb_llm_tpu_torch.ops.packed_matmul_v1 import planar_arm, select_arm, use_planar

    counts = {"pb_planar_v1": 0, "pb_planar_v1_tc": 0, "pb_select_v1": 0, "pb_select_v1_tc": 0}
    for _, m in forwards:
        for p in linears:
            kind = PLANAR_COUNTERS[planar_arm(p)] if use_planar(m, p) else (
                "pb_select_v1_tc" if select_arm(m, p) == "tc" else "pb_select_v1")
            counts[kind] += 1
    n_decode = sum(kind == "decode" for kind, _ in forwards)
    return expect_launches(**counts, **attention_launches(n_layers * n_decode))


def serve_v1_e2e(params, cfg, build_s: float, card: str):
    """Phase 7b: the 24-layer full-width OPT-1.3B with random PBW-v1 planes
    through `ContinuousBatcher`, `Engine(n_slots=8, max_seq=2048)`, int8
    strips, phase 4's request mix.  Each forward's rows m decide, linear by
    linear, which kernel (and select arm) it must have launched
    (`use_planar`, `select_arm`); the prefill forwards' synchronised time is
    summed (`prefill_ms_total`).  The mix is then served twice more on the
    same engine, the select kernel's arm forced to "cores" and back to the
    rule's, for the two arms' prefill time in turns."""
    from pb_llm_tpu_torch.core.pbw import PackedLinear
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    eng = Engine(params, cfg, family_for("opt"), EngineConfig(n_slots=8, max_seq=2048), device=DEV)
    linears = [v for lp in params["layers"] for v in lp.values() if isinstance(v, PackedLinear)]
    assert eng.cache_dtype == torch.int8 and len(linears) == 6 * cfg.num_hidden_layers
    plane_bytes = sum(v1_plane_bytes(p) for p in linears)
    head_bytes = params["embed_tokens"].numel() * params["embed_tokens"].element_size()
    reqs = e2e_requests(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    batcher, launches, forwards, step_ms, kv_rows, prefill_ms = run_counted(eng, reqs)

    want = v1_launches(forwards, linears, cfg.num_hidden_layers)
    n_decode = sum(kind == "decode" for kind, _ in forwards)
    kv_row_bytes = cfg.num_hidden_layers * cfg.num_attention_heads * (2 * cfg.head_dim + 8)
    mean_rows = statistics.mean(kv_rows)
    s = batcher.stats
    row = {"phase": "v1_e2e", "model": "OPT-1.3B PBW v1 (random planes, low_frac 0.9, whole-row "
           "scales)", "layers": cfg.num_hidden_layers, "slots": 8, "max_seq": 2048,
           "kv": "int8 strips", "requests": len(reqs), "generated_tokens": s.generated_tokens,
           "wall_s": s.wall_seconds, "tokens_per_s": s.tokens_per_second,
           "decode_steps": len(step_ms), "ms_per_decode_step_median": statistics.median(step_ms),
           "ms_per_decode_step_mean": statistics.mean(step_ms), "decode_forwards": n_decode,
           "prefill_forward_rows": sorted(m for kind, m in forwards if kind == "prefill"),
           "prefill_ms_total": sum(prefill_ms), "SELECT_TC": v1.SELECT_TC,
           "PLANAR_ARM": v1.PLANAR_ARM,
           "launches": launches, "planar_launches_per_decode_step": len(linears),
           "packed_plane_bytes": plane_bytes, "tied_head_bytes": head_bytes,
           "mean_kv_rows_per_step": mean_rows,
           "decode_step_bound_ms": (plane_bytes + head_bytes + mean_rows * kv_row_bytes)
           / HBM_BYTES_PER_S * 1e3,
           "build_s": build_s, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    if launches != want or not (launches["pb_planar_v1_tc"] and launches["pb_select_v1_tc"]):
        log(json.dumps(row))
        raise AssertionError(f"v1 e2e: launches {launches}, expected {want} for {forwards}")
    if not all(v1.use_planar(m, p) for kind, m in forwards if kind == "decode" for p in linears):
        raise AssertionError("v1 e2e: a decode step left the planar kernel")
    # the select arms in turns: "cores" (SELECT_TC past every forward), then the rule again
    turns = {}
    rule = v1.SELECT_TC
    for name, tc in (("cores", 1 << 30), ("rule", rule)):
        v1.SELECT_TC = tc
        try:
            _, got, fwd, t_ms, _, p_ms = run_counted(eng, e2e_requests(cfg.vocab_size))
        finally:
            v1.SELECT_TC = rule
        ok = (got == v1_launches(fwd, linears, cfg.num_hidden_layers) if name == "rule"
              else got["pb_select_v1"] > 0 and got["pb_select_v1_tc"] == 0)
        if not ok:
            raise AssertionError(f"v1 e2e ({name} turn): launches {got}")
        turns[name] = {"prefill_ms_total": sum(p_ms), "ms_per_decode_step_median":
                       statistics.median(t_ms), "select_launches": got["pb_select_v1"]
                       + got["pb_select_v1_tc"]}
    row["turns"] = turns
    log(json.dumps(row))
    return row


def producer_v1(card: str):
    """Phase 8: run_ptq's PBW-v1 path at OPT-1.3B's widths (2 layers):
    synthetic calibration windows, GPTQ-PB (xnor, low_frac 0.9, hessian
    saliency, element masks, groups of 128, 8-bit codes) into PBW v1
    (`fmt="packed"`), then windowed perplexity with the kernels and with
    their plain versions on the card."""
    from pb_llm_tpu_torch.calib.pipeline import quantize_model_ptq
    from pb_llm_tpu_torch.calib.solver import SolverConfig
    from pb_llm_tpu_torch.core.pbw import PackedLinear
    from pb_llm_tpu_torch.data.loaders import get_loaders
    from pb_llm_tpu_torch.data.synthetic import ByteTokenizer, synthetic_source
    from pb_llm_tpu_torch.eval.ppl import perplexity
    from pb_llm_tpu_torch.models.opt import init_params
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops import kernel_config as kc
    from pb_llm_tpu_torch.ops.packed_matmul_v1 import select_arm

    cfg = opt13b(2)
    fam = family_for("opt")
    tok, source = ByteTokenizer(), synthetic_source()
    calib, _ = get_loaders("wikitext2", tok, nsamples=PTQ_NSAMPLES, seed=0, seqlen=PTQ_SEQLEN,
                           flavor="ptq", source=source)
    _, evaltok = get_loaders("wikitext2", tok, nsamples=2, seed=0, seqlen=PTQ_SEQLEN, flavor="ptq",
                             source=source)
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(19), device=DEV)
    scfg = SolverConfig(low_method="xnor", low_frac=0.9, high_bit=8, salient_metric="hessian",
                        groupsize=128)
    kc.pin_exact_prefill()  # as run_ptq / run_eval do
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    params, report = quantize_model_ptq(params, cfg, fam, calib, scfg, fmt="packed", log=None,
                                        capture_batch=PTQ_NSAMPLES)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ppl = perplexity(params, cfg, fam.forward, evaltok, seqlen=PTQ_SEQLEN,
                     window_limit=PPL_WINDOWS, window_batch=PPL_BATCH)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plain = kc.KernelConfig(backend="pallas_interpret", prefill="hybrid", attention="flash_interpret")
    with kc.use_kernels(plain):
        ppl_plain = perplexity(params, cfg, fam.forward, evaltok, seqlen=PTQ_SEQLEN,
                               window_limit=PPL_WINDOWS, window_batch=PPL_BATCH)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    if read_counters() != launches:
        raise AssertionError("v1 producer: the plain-version perplexity launched a kernel")
    packed = [v for lp in params["layers"] for v in lp.values() if isinstance(v, PackedLinear)]
    salient = float(np.mean([1.0 - m.mean() for m in report.masks.values()]))
    forwards = -(-PPL_WINDOWS // PPL_BATCH)
    chunks = 1  # capture_batch == nsamples: one calibration chunk per layer
    # every forward has at least PTQ_SEQLEN rows: one arm (select_arm) takes them all
    arm = "pb_select_v1_tc" if select_arm(PTQ_SEQLEN, packed[0]) == "tc" else "pb_select_v1"
    want = expect_launches(**{arm: len(packed) * (chunks + forwards)},
                           flash_attention_tc=cfg.num_hidden_layers * (2 * chunks + forwards))
    row = {"phase": "producer_v1", "model": "OPT-1.3B widths, 2 layers, random-init f32 weights",
           "calib": f"synthetic wikitext2 (ptq flavor), {PTQ_NSAMPLES} x {PTQ_SEQLEN}",
           "solver": "xnor low_frac 0.9 hessian high_bit 8 groupsize 128, element masks, packed",
           "salient_frac": salient, "effective_bits": float(np.mean([p.effective_bits() for p in packed])),
           "ppl_windows": PPL_WINDOWS, "ppl_batch": PPL_BATCH, "ppl": ppl, "ppl_plain": ppl_plain,
           "ppl_rel_diff": abs(ppl - ppl_plain) / ppl_plain, "quantize_s": t1 - t0,
           "ppl_s": t2 - t1, "ppl_plain_s": t3 - t2, "layer_seconds": report.layer_seconds,
           "layer_output_mse": report.layer_output_mse, "total_gptq_error": sum(report.errors.values()),
           "packed_linears": len(packed), "launches": launches, "peak_mem_gb": peak_gb, "card": card}
    log(json.dumps(row))
    if len(packed) != 6 * cfg.num_hidden_layers:
        raise AssertionError(f"v1 producer: {len(packed)} packed linears")
    if not (np.isfinite(ppl) and np.isfinite(ppl_plain)):
        raise AssertionError(f"v1 producer: perplexity {ppl} / {ppl_plain}")
    if abs(ppl - ppl_plain) > PPL_RTOL * ppl_plain:
        raise AssertionError(f"v1 producer: ppl {ppl} (kernels) vs {ppl_plain} (plain versions)")
    if launches != want:
        raise AssertionError(f"v1 producer: launches {launches}, expected {want}")
    return row


# ---------------------------------------------------------------------------
# phases 9a and 9b: scanned layers, fused linears, the pair and dma arms
# ---------------------------------------------------------------------------

def scan_fuse_parity(params, card: str):
    """Phase 9a on 2 full-width llama-7b layers.  On the exact arms
    (INV_ARMS, f32 KV): scan_layers equals unrolled over strips and over
    pages of 16 (the stacked f32 kernel at decode), fuse_linears equals
    unfused, under the margin rule.  Then the pair and dma arms, and
    scan_layers on the exact arms (the stacked f32 entry's tensor-core arm
    at its prefill windows), on the card against the CPU's plain versions
    (run_parity): dma and the exact arms are exact, held to
    LOGIT_TOL_EXACT; pair rounds x to bf16, where a one-ulp difference in x
    between the devices can move a rounding step, held to LOGIT_TOL."""
    from pb_llm_tpu_torch.interop import to_device
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig

    cfg = llama7b(2)
    params = to_device(params, DEV)
    rng = np.random.default_rng(21)
    short = [rng.integers(0, cfg.vocab_size, int(rng.integers(20, 121))).tolist() for _ in range(8)]
    t0 = time.perf_counter()
    out = []
    zero_counters()
    strip, _ = serve_streams(params, cfg, short)
    scanned, _ = serve_streams(params, cfg, short, scan_layers=True)
    out.append(hold_streams(params, cfg, "scan_layers vs unrolled (strips)", short, strip, scanned))
    paged, _ = serve_streams(params, cfg, short, page_size=16)
    paged_scan, _ = serve_streams(params, cfg, short, page_size=16, scan_layers=True)
    out.append(hold_streams(params, cfg, "scan_layers vs unrolled (pages)", short, paged, paged_scan))
    fused, _ = serve_streams(params, cfg, short, fuse_linears=True)
    out.append(hold_streams(params, cfg, "fuse_linears vs unfused", short, strip, fused))
    torch.cuda.synchronize()
    launches = read_counters()
    arms = []
    # (arm, engine options, bound, the kernel that must launch): the decode
    # arms (pair's prompts in 128-row windows: its "tc" arm, decode on
    # "split"), and scan_layers on the exact arms, whose 64- and 256-row
    # prefill windows take the stacked f32 entry's tensor-core arm
    for arm, ekw, tol, kernel in (("dma", {}, LOGIT_TOL_EXACT, "pb_dma_v2_split"),
                                  ("pair", dict(buckets=(128, 256)), LOGIT_TOL, "pb_pair_v2_tc"),
                                  ("f32", dict(scan_layers=True), LOGIT_TOL_EXACT,
                                   "pb_f32_matmul_stacked_tc")):
        kw = dict(decode_dot=arm, prefill="hybrid")
        zero_counters()
        g_logits, g_toks, g_nll = run_parity(params, cfg, DEV, kernels=KernelConfig(**kw), **ekw)
        torch.cuda.synchronize()
        arm_launches = read_counters()
        c_logits, c_toks, c_nll = run_parity(
            params, cfg, "cpu", cache_dtype=torch.int8, kernels=KernelConfig(
                backend="pallas_interpret", decode_attention="pallas_interpret", **kw), **ekw)
        scale = c_logits.abs().max().item()
        err = (g_logits - c_logits).abs().max().item()
        row = {"arm": arm, **{k: list(v) if isinstance(v, tuple) else v for k, v in ekw.items()},
               "max_abs_logit_err": err, "err_over_max_logit": err / scale,
               "tol_over_max_logit": tol, "gpu_tokens": g_toks, "cpu_tokens": c_toks,
               "gpu_nll": g_nll, "cpu_nll": c_nll, "launches": arm_launches}
        arms.append(row)
        if not (np.isfinite(g_nll) and torch.isfinite(g_logits).all()):
            raise AssertionError(f"phase 9a ({arm}): non-finite GPU output")
        if err > tol * scale or g_toks != c_toks or abs(g_nll - c_nll) > NLL_RTOL * abs(c_nll):
            raise AssertionError(f"phase 9a ({arm}): card and CPU differ: {row}")
        if sum(n for k, n in arm_launches.items() if k.startswith(kernel)) == 0:
            raise AssertionError(f"phase 9a ({arm}): {kernel} never launched")
    row = {"phase": "scan_fuse_parity", "layers": 2, "arms": INV_ARMS, "checks": out,
           "launches": launches, "decode_arms_card_vs_cpu": arms,
           "stacked_f32_tc_launches": arms[-1]["launches"]["pb_f32_matmul_stacked_tc"],
           "stacked_f32_split_launches": launches["pb_f32_matmul_stacked_split"],
           "pair_launches": {k: v for k, v in arms[1]["launches"].items() if "pair" in k},
           "seconds": time.perf_counter() - t0, "card": card}
    log(json.dumps(row))
    if launches["pb_f32_matmul_stacked_split"] == 0:
        raise AssertionError("phase 9a: the stacked f32 kernel's decode arm never launched")
    return row


def serve_scan_fuse_e2e(params, card: str):
    """Phase 9b: phase 4's 32-layer model, engine and request mix in three
    passes, each on a fresh engine: (i) scan_layers on the int8 arms,
    (ii) fuse_linears with decode_dot pair, (iii) decode_dot dma.  A forward
    of m rows runs each packed linear once: (i) through the stacked int8
    kernel where m <= 256, else the flat int8 kernel on the layer's views;
    (ii) and (iii) through the pair / dma kernel where m < 256, else the
    int8 prefill kernel; decode attention once a layer per decode step.
    The int8 kernels' launches are checked by arm (`int8_launches`)."""
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg = llama7b(32)
    n_layers = cfg.num_hidden_layers
    passes = (("scan_layers", dict(scan_layers=True), None, 7, "pb_int8_matmul_stacked", 256),
              ("fuse_linears + pair", dict(fuse_linears=True), "pair", 4, "pb_pair_v2", 255),
              ("dma", dict(), "dma", 7, "pb_dma_v2_split", 255))
    rows = []
    p0 = first_linear(params)
    for name, ekw, arm, per_layer, kernel, max_rows in passes:
        kernels = KernelConfig(decode_dot=arm) if arm else None
        eng = Engine(params, cfg, family_for("llama"),
                     EngineConfig(n_slots=8, max_seq=2048, kernels=kernels, **ekw), device=DEV)
        assert eng.cache_dtype == torch.int8
        torch.cuda.reset_peak_memory_stats()
        batcher, launches, fwds, step_ms, _, prefill_ms = run_counted(
            eng, e2e_requests(cfg.vocab_size))
        small = [m for _, m in fwds if m <= max_rows]  # through the pass's kernel
        big = [m for _, m in fwds if m > max_rows]     # through the flat int8 kernel
        n_decode = sum(kind == "decode" for kind, _ in fwds)
        n_lin = per_layer * n_layers
        if kernel == "pb_int8_matmul_stacked":  # the stacked entry's two arms
            own, n_prep = int8_launches(small, n_lin, p0, kernel), len(fwds)
        elif kernel == "pb_pair_v2":  # the pair kernel's arms, by rows
            own, n_prep = pair_launches(small, n_lin, first_linear(eng.params)), len(big)
        else:  # dma: its arm ("split" on llama-7b's layouts) and that arm's x preparation
            own = dma_launches(small, n_lin, first_linear(eng.params))
            n_prep = len(big)
        want = expect_launches(**own, **int8_launches(big, n_lin, p0),
                               pb_prep_int8=n_lin * n_prep,
                               **attention_launches(n_layers * n_decode))
        n_small = len(small)
        s = batcher.stats
        row = {"phase": "scan_fuse_e2e", "pass": name, "model": "llama-7b PBW-v2 (random planes, "
               "low_frac 0.9)", "layers": n_layers, "slots": 8, "max_seq": 2048,
               "kv": "int8 strips", "decode_dot": arm or "int8 (auto)",
               "generated_tokens": s.generated_tokens, "wall_s": s.wall_seconds,
               "tokens_per_s": s.tokens_per_second, "decode_steps": len(step_ms),
               "ms_per_decode_step_median": statistics.median(step_ms),
               "ms_per_decode_step_mean": statistics.mean(step_ms),
               "forwards": len(fwds), "forwards_through_the_kernel": n_small,
               "prefill_forward_rows": sorted(m for kind, m in fwds if kind == "prefill"),
               "prefill_ms_total": sum(prefill_ms),
               "launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "card": card}
        log(json.dumps(row))
        if launches != want or sum(own.values()) == 0:
            raise AssertionError(f"phase 9b ({name}): launches {launches}, expected {want}")
        rows.append(row)
        del eng, batcher
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 10a and 10b: bf16 and q8 KV caches, and the HTTP front end
# ---------------------------------------------------------------------------

# the three KV layouts that reach the bf16 and q8 kernel arms: engine
# options, decode_attention arm, the arm's launch counter
KV_PASSES = (
    ("int8 strips + pallas_q8", dict(cache_dtype=torch.int8), "pallas_q8",
     "decode_attention_q8"),
    ("bf16 strips", dict(cache_dtype=torch.bfloat16), "auto", "decode_attention_bf16"),
    ("bf16 pages + prefix cache", dict(cache_dtype=torch.bfloat16, page_size=16,
                                       prefix_cache=True), "auto", "paged_attention_bf16"),
)
SHARED_PREFIX = 32  # phase 10a's second prompt shares two pages of the first
HTTP_CLIENTS = 8    # phase 10b's client threads


def check_kv_parity(params, card: str):
    """Phase 10a on 2 full-width llama-7b layers, the int8 matmul arms: each
    of KV_PASSES on the card (kernels) against the CPU (plain versions;
    "pallas_q8" on a CPU tensor takes the plain q8 arm) under phase 3's
    bounds.  The second prompt shares 32 tokens with the first: over pages
    it attaches two cached pages and prefills its suffix as a window."""
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig

    cfg = llama7b(2)
    arm_kw = dict(decode_dot="int8", prefill="int8")
    rows = []
    for name, ekw, impl, counter in KV_PASSES:
        zero_counters()
        t0 = time.perf_counter()
        g_logits, g_toks, g_nll = run_parity(params, cfg, DEV, shared=SHARED_PREFIX,
                                             kernels=KernelConfig(decode_attention=impl, **arm_kw),
                                             **ekw)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        launches = read_counters()
        cpu_impl = "pallas_q8" if impl == "pallas_q8" else "pallas_interpret"
        t0 = time.perf_counter()
        c_logits, c_toks, c_nll = run_parity(
            params, cfg, "cpu", shared=SHARED_PREFIX, kernels=KernelConfig(
                backend="pallas_interpret", decode_attention=cpu_impl, **arm_kw), **ekw)
        cpu_s = time.perf_counter() - t0
        if read_counters() != launches:
            raise AssertionError(f"phase 10a ({name}): the CPU run launched a kernel")
        scale = c_logits.abs().max().item()
        err = (g_logits - c_logits).abs().max().item()
        row = {"phase": "kv_parity", "pass": name, "layers": 2, "max_abs_logit_err": err,
               "max_abs_logit": scale, "err_over_max_logit": err / scale,
               "tol_over_max_logit": LOGIT_TOL, "gpu_tokens": g_toks, "cpu_tokens": c_toks,
               "gpu_nll": g_nll, "cpu_nll": c_nll, "launches": launches, "gpu_s": gpu_s,
               "cpu_s": cpu_s, "card": card}
        log(json.dumps(row))
        if not (np.isfinite(g_nll) and torch.isfinite(g_logits).all()):
            raise AssertionError(f"phase 10a ({name}): non-finite GPU output")
        if err > LOGIT_TOL * scale or g_toks != c_toks or abs(g_nll - c_nll) > NLL_RTOL * abs(c_nll):
            raise AssertionError(f"phase 10a ({name}): card and CPU differ: {row}")
        if launches[counter] == 0:
            raise AssertionError(f"phase 10a ({name}): the {counter} arm never launched")
        if "page_size" in ekw and launches["paged_attention_multi"] == 0:
            raise AssertionError(f"phase 10a ({name}): the prefix suffix took no window launch")
        rows.append(row)
    return rows


def http_clients(port: int, prompts):
    """POST each prompt to /generate from HTTP_CLIENTS threads (request i on
    thread i % HTTP_CLIENTS), every other one with "stream": true.  Returns
    per request (output_ids, streamed tokens or None, seconds)."""
    import threading
    import urllib.request

    out = [None] * len(prompts)

    def post(i):
        body = {"prompt_ids": prompts[i], "max_new_tokens": E2E_NEW, "stream": i % 2 == 1}
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            text = r.read().decode()
        if body["stream"]:
            lines = [json.loads(line) for line in text.splitlines()]
            streamed = [line["token"] for line in lines[:-1]]
            out[i] = (lines[-1]["output_ids"], streamed, time.perf_counter() - t)
        else:
            out[i] = (json.loads(text)["output_ids"], None, time.perf_counter() - t)

    def worker(w):
        for i in range(w, len(prompts), HTTP_CLIENTS):
            post(i)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(HTTP_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def timed_direct(eng, vocab: int):
    """Phase 4's requests through `ContinuousBatcher` on ``eng`` directly:
    (tokens/s, ms of each decode step, device synchronised)."""
    from pb_llm_tpu_torch.runtime.batching import ContinuousBatcher

    step_ms, dec = [], eng.decode_step

    def timed_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = dec()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    eng.decode_step = timed_step
    batcher = ContinuousBatcher(eng)
    batcher.run(e2e_requests(vocab))
    del eng.decode_step  # the class's method again
    return batcher.stats.tokens_per_second, step_ms


def serve_http_e2e(params, card: str, phase4: dict):
    """Phase 10b: the 32-layer llama-7b of phase 4 behind `serve_http` on
    127.0.0.1, phase 4's 16 requests posted from 8 client threads (every
    other one streamed), once for each of KV_PASSES (the pages with
    prefill_chunk 256).  Each pass: a fresh engine, the counters zeroed
    before the server starts and read after it and its scheduler have
    stopped; every launch must match the forwards run.  The same requests
    run through the batcher directly just before and just after the HTTP
    run, each on a fresh engine of the same configuration (a used pool's
    prefix cache would hit): the host's speed drifts within a call, so the
    HTTP front end's cost is read against these, not against phase 4."""
    import urllib.request

    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig
    from pb_llm_tpu_torch.runtime.batching import ContinuousBatcher, Request
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig
    from pb_llm_tpu_torch.runtime.server import serve_http

    cfg = llama7b(32)
    n_layers, n_linear = cfg.num_hidden_layers, 7 * cfg.num_hidden_layers
    prompts = [r.prompt_ids for r in e2e_requests(cfg.vocab_size)]
    rows = []
    for name, ekw, impl, counter in KV_PASSES:
        paged = "page_size" in ekw

        def fresh_engine():
            gc.collect()  # the last engine (patched methods form cycles), earlier phases'
            torch.cuda.empty_cache()
            eng = Engine(params, cfg, family_for("llama"),
                         EngineConfig(n_slots=8, max_seq=2048, kernels=KernelConfig(
                             decode_attention=impl), prefill_chunk=256 if paged else 0, **ekw),
                         device=DEV)
            ContinuousBatcher(eng).run([Request(request_id=-1, prompt_ids=[1, 2, 3],
                                                max_new_tokens=2)])  # cuBLAS, allocator
            return eng

        direct = [timed_direct(fresh_engine(), cfg.vocab_size)]
        eng = fresh_engine()
        forwards = {"prefill": 0, "decode": 0, "window": 0}
        finite = torch.ones((), dtype=torch.bool, device=DEV)
        step_ms, fwd_rows = [], []
        dec = eng.decode_step

        def on_forward(kind, rows, caches, pos, logits):
            nonlocal finite
            if kind is None:  # a chunk or a prefix-cache suffix, or a prefill
                kind = "window" if isinstance(caches, list) and "chunk_table" in caches[0] \
                    else "prefill"
            forwards[kind] += 1
            fwd_rows.append(rows)
            finite = finite & torch.isfinite(logits).all()

        def timed_step():
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = dec()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            return out

        restore = count_forwards(eng, on_forward)
        eng.decode_step = timed_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        server = serve_http(eng, host="127.0.0.1", port=0)
        port = server.server_address[1]
        t0 = time.perf_counter()
        results = http_clients(port, prompts)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60) as r:
            stats = json.loads(r.read())
        server.shutdown()
        server.server_close()
        server.serving_loop.shutdown()
        if server.serving_loop._thread.is_alive():
            raise AssertionError(f"phase 10b ({name}): the scheduler thread did not stop")
        torch.cuda.synchronize()
        launches = read_counters()
        restore()
        del eng.decode_step  # the class's method again
        direct.append(timed_direct(fresh_engine(), cfg.vocab_size))
        direct_ms = [statistics.median(ms) for _, ms in direct]
        received = sum(len(ids) for ids, _, _ in results)
        decode_fwd = forwards["decode"]
        if paged:
            want = expect_launches(**int8_launches(fwd_rows, n_linear, first_linear(params)),
                                   pb_prep_int8=n_linear * sum(forwards.values()),
                                   paged_attention_decode=n_layers * decode_fwd,
                                   paged_attention_split=n_layers * decode_fwd * paged_split(cfg),
                                   paged_attention_multi=n_layers * forwards["window"],
                                   paged_attention_window=n_layers * forwards["window"],
                                   paged_attention_bf16=n_layers * (decode_fwd
                                                                    + forwards["window"]))
        else:
            want = expect_launches(**int8_launches(fwd_rows, n_linear, first_linear(params)),
                                   pb_prep_int8=n_linear * sum(forwards.values()),
                                   **attention_launches(n_layers * decode_fwd),
                                   **{counter: n_layers * decode_fwd})
        row = {"phase": "http_e2e", "pass": name, "model": "llama-7b PBW-v2 (random planes, "
               "low_frac 0.9)", "layers": n_layers, "slots": 8, "max_seq": 2048,
               "requests": len(prompts), "client_threads": HTTP_CLIENTS,
               "streamed": sum(s is not None for _, s, _ in results),
               "tokens_received": received, "client_wall_s": wall,
               "client_tokens_per_s": received / wall,
               "tokens_per_s": stats["tokens_per_second"], "stats": stats,
               "request_s_median": statistics.median(t for _, _, t in results),
               "decode_steps": len(step_ms), "ms_per_decode_step_median": statistics.median(step_ms),
               "ms_per_decode_step_mean": statistics.mean(step_ms),
               "direct_tokens_per_s_before_after": [tps for tps, _ in direct],
               "direct_ms_per_decode_step_median_before_after": direct_ms,
               "http_over_direct_step": statistics.median(step_ms) / statistics.mean(direct_ms),
               "phase4_tokens_per_s": phase4["tokens_per_s"],
               "phase4_ms_per_decode_step_median": phase4["ms_per_decode_step_median"],
               "phase4_ms_per_decode_step_mean": phase4["ms_per_decode_step_mean"],
               "forwards": forwards, "launches": launches,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
        log(json.dumps(row))
        if not bool(finite):
            raise AssertionError(f"phase 10b ({name}): non-finite logits")
        if not all(len(ids) == E2E_NEW for ids, _, _ in results):
            raise AssertionError(f"phase 10b ({name}): a request lacks its tokens")
        if not all(s is None or s == ids for ids, s, _ in results):
            raise AssertionError(f"phase 10b ({name}): a stream differs from its output_ids")
        if health != {"status": "ok"} or stats["generated_tokens"] != received:
            raise AssertionError(f"phase 10b ({name}): /health {health}, /stats {stats}, "
                                 f"{received} tokens received")
        if launches != want or launches[counter] == 0:
            raise AssertionError(f"phase 10b ({name}): launches {launches}, expected {want} "
                                 f"for {forwards}")
        rows.append(row)
        del eng, server, dec, restore
    return rows


# ---------------------------------------------------------------------------
# phases 11a and 11b: the decode step as one CUDA graph; the paged windows
# ---------------------------------------------------------------------------

# engine options and kernel-config options of each graph = eager pass
GRAPH_PASSES = (
    ("int8 strips", {}, {}),
    ("scan_layers", dict(scan_layers=True), {}),
    ("fuse_linears + pair", dict(fuse_linears=True), dict(decode_dot="pair")),
    ("dma", {}, dict(decode_dot="dma")),
    ("int8 strips + pallas_q8", {}, dict(decode_attention="pallas_q8")),
    ("bf16 strips", dict(cache_dtype=torch.bfloat16), {}),
    ("int8 pages + prefix cache", dict(page_size=16, prefix_cache=True), {}),
    ("bf16 pages + prefix cache", dict(page_size=16, prefix_cache=True,
                                       cache_dtype=torch.bfloat16), {}),
)
# (op, slot, prompt): 18 decode steps, slots admitted and released between
GRAPH_PLAN = (("admit", 0, 0), ("admit", 1, 1), ("admit", 2, 2), ("steps", 6, None),
              ("release", 1, None), ("admit", 1, 3), ("steps", 6, None), ("release", 0, None),
              ("release", 2, None), ("admit", 3, 4), ("steps", 6, None))


def graph_pass(name: str, dparams, cfg, family: str, ekw: dict, kkw: dict, prompts,
               card: str) -> dict:
    """One graph = eager pass of phase 11a (see `graph_parity`)."""
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig
    from pb_llm_tpu_torch.runtime import step_graph
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    runs = {}
    for mode in ("eager", "graph"):
        gc.collect()
        eng = Engine(dparams, cfg, family_for(family),
                     EngineConfig(n_slots=4, max_seq=256, prefill_buckets=(64, 256),
                                  kernels=KernelConfig(**kkw), **ekw), device=DEV)
        toks, logits = [], []

        def on_forward(kind, rows_, caches, pos, lg, eng=eng):
            if kind == "decode":  # the active slots' rows (see graph_parity)
                logits.append(lg[torch.from_numpy(np.flatnonzero(eng.active)).to(DEV)])

        restore = count_forwards(eng, on_forward)
        zero_counters()
        t0 = time.perf_counter()
        with step_graph.eager() if mode == "eager" else contextlib.nullcontext():
            for op, a, prompt in GRAPH_PLAN:
                if op == "admit":
                    toks.append({a: eng.prefill(a, prompts[prompt])})
                elif op == "release":
                    eng.release(a)
                else:
                    toks += [eng.decode_step() for _ in range(a)]
        torch.cuda.synchronize()
        runs[mode] = (toks, logits, read_counters(), eng._step.replays,
                      time.perf_counter() - t0)
        restore()
        del eng
    (gt, gl, gla, grep, gs), (et, el, ela, erep, es) = runs["graph"], runs["eager"]
    unequal = sum(not torch.equal(a, b) for a, b in zip(gl, el))
    row = {"phase": "graph_parity", "pass": name, "layers": cfg.num_hidden_layers,
           "decode_steps": len(gl), "tokens_equal": gt == et, "logit_steps_unequal": unequal,
           "max_abs_logit_diff": max((a - b).abs().max().item() for a, b in zip(gl, el)),
           "launches_equal": gla == ela, "graph_replays": grep, "graph_s": gs,
           "eager_s": es, "launches": gla, "card": card}
    log(json.dumps(row))
    if len(gl) != len(el) or len(gl) < 16 or grep == 0 or erep != 0:
        raise AssertionError(f"phase 11a ({name}): {len(gl)} / {len(el)} steps, "
                             f"{grep} / {erep} replays")
    if gt != et or unequal or gla != ela:
        raise AssertionError(f"phase 11a ({name}): graph and eager differ: {row}")
    return row


def graph_parity(params, card: str):
    """Phase 11a on 2 full-width llama-7b layers, the int8 matmul arms:
    each of GRAPH_PASSES twice on fresh engines, under `step_graph.eager()`
    and graphed; GRAPH_PLAN admits and releases slots between decode steps
    (prompts share a 32-token prefix: a prefix-cache hit over pages).  The
    same greedy tokens, bitwise-equal logits of the active slots at every
    decode step and the same launches by kind.  (An inactive slot's row is
    not an output: over pages, every inactive slot writes its token into
    the trash page at the same offset, and which duplicate write lands is
    not fixed from run to run.)  Then the same on phase 7a's 2 full-width
    OPT-1.3B layers (PBW v1, groups of 128), whose decode takes the planar
    kernel's arm "tc"."""
    from pb_llm_tpu_torch.data.synthetic import random_packed_opt
    from pb_llm_tpu_torch.interop import to_device

    cfg = llama7b(2)
    dparams = to_device(params, DEV)
    rng = np.random.default_rng(21)
    prefix = rng.integers(0, cfg.vocab_size, SHARED_PREFIX).tolist()
    prompts = [prefix + rng.integers(0, cfg.vocab_size, n).tolist() for n in (8, 40, 20, 60, 30)]
    rows = [graph_pass(name, dparams, cfg, "llama", ekw, kkw, prompts, card)
            for name, ekw, kkw in GRAPH_PASSES]
    del dparams
    ocfg = opt13b(2)
    oparams = random_packed_opt(ocfg, torch.Generator(device=DEV).manual_seed(16), groupsize=128)
    prompts = [rng.integers(0, ocfg.vocab_size, n).tolist() for n in (40, 72, 52, 92, 62)]
    row = graph_pass("OPT-1.3B PBW v1", oparams, ocfg, "opt", {}, {}, prompts, card)
    if not row["launches"]["pb_planar_v1_tc"] or row["launches"]["pb_planar_v1"]:
        raise AssertionError(f"phase 11a (OPT-1.3B): planar launches by arm {row['launches']}")
    rows.append(row)
    del oparams
    torch.cuda.empty_cache()
    return rows


WINDOW_NEW = 6  # phase 11b: decode steps after each prompt


def run_windows(params, cfg, dev, kernels, kind, prompts, forced=None):
    """Phase 11b's engine: each prompt chunk-prefilled into its own slot
    (pages of 16, prefill_chunk 64, the prefix cache), then WINDOW_NEW
    decode steps; greedy, or with ``forced`` (the tokens of another run)
    fed in teacher-forced.  Returns the argmax token and the logits of
    every step (the prefill's and each decode step's), the launches by
    kind and the prefix-hit pages."""
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    eng = Engine(params, cfg, family_for("llama"),
                 EngineConfig(n_slots=len(prompts), max_seq=256, prefill_buckets=(64, 256),
                              page_size=16, prefix_cache=True, prefill_chunk=64,
                              cache_dtype=kind, kernels=kernels), device=dev)
    zero_counters()
    steps, seen = [], []
    step = eng._step_logits

    def recorded():
        out = step()
        seen.append(out.float().cpu().clone())
        return out

    eng._step_logits = recorded
    for slot, prompt in enumerate(prompts):
        eng.start_chunked_prefill(slot, prompt)
        while eng.prefill_chunk_step(slot) is None:
            pass
        steps.append(eng._prefill_logits[slot].float().cpu())
        first = len(seen)
        if forced is None:
            for _ in range(WINDOW_NEW):
                eng.decode_step()
        else:
            eng.forced_decode_nll(slot, forced[len(steps) - 1:len(steps) + WINDOW_NEW])
        steps += [out[slot] for out in seen[first:]]
    if dev == DEV:
        torch.cuda.synchronize()
    toks = [int(x.argmax()) for x in steps]
    return toks, torch.stack(steps), read_counters(), eng.pool.prefix_hit_pages


@contextlib.contextmanager
def windows_on_cuda_cores():
    """Route every paged window to the CUDA-core arm (the arm before the
    tensor cores), for phase 11b's comparison of the two arms."""
    from pb_llm_tpu_torch.ops import paged_attention as tpa

    rule = tpa.window_arm
    tpa.window_arm = lambda t, *a: tpa.CUDA_CORES if t > 1 else rule(t, *a)
    try:
        yield
    finally:
        tpa.window_arm = rule


def first_parting(toks, c_toks, c_steps):
    """The first token where a greedy stream parts from the CPU's, and the
    CPU's top-2 logit gap there over max|logit|, or (None, None)."""
    i = next((i for i, (a, b) in enumerate(zip(toks, c_toks)) if a != b), None)
    if i is None:
        return None, None
    top = torch.topk(c_steps[i], 2).values
    return i, (top[0] - top[1]).item() / c_steps[i].abs().max().item()


def window_parity(params, card: str):
    """Phase 11b on 2 full-width llama-7b layers over int8 and over bf16
    pages with prefill_chunk 64 and the prefix cache: a 150-token prompt
    prefilled in three chunks, a second one sharing its first 96 tokens (a
    prefix hit, its suffix chunked from 64), 6 decode steps after each; the
    card (the tensor-core window arm) against the CPU (plain versions).

    Exact matmul arms: greedy tokens equal, prefill logits within
    LOGIT_TOL_EXACT.  Int8 matmul arms (the serving default): a last-bit
    difference between the devices can move an int8 rounding of x and the
    logits by up to phase 10a's LOGIT_TOL, so where this random model's
    top two logits lie closer, the greedy streams may part.  The card is
    therefore also run teacher-forced on the CPU's tokens, and every step's
    logits (2 prefills, 12 decode steps) must lie within LOGIT_TOL of the
    CPU's; the steps whose argmax differs are logged.  The greedy streams
    of both window arms (tensor and CUDA cores) are logged beside it: the
    first token where each parts from the CPU's, and the CPU's top-2 gap
    there."""
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig

    cfg = llama7b(2)
    rng = np.random.default_rng(23)
    first = rng.integers(0, cfg.vocab_size, 150).tolist()
    prompts = (first, first[:96] + rng.integers(0, cfg.vocab_size, 50).tolist())
    rows = []
    for arms, arm_kw in (("int8", dict(decode_dot="int8", prefill="int8")),
                         ("exact", INV_ARMS)):
        card_kernels = KernelConfig(**arm_kw)
        cpu_kernels = KernelConfig(backend="pallas_interpret",
                                   decode_attention="pallas_interpret", **arm_kw)
        for kind in (torch.int8, torch.bfloat16):
            what = f"phase 11b ({arms} arms, {kind})"
            c_toks, c_steps, c_launches, _ = run_windows(params, cfg, "cpu", cpu_kernels, kind,
                                                         prompts)
            if any(c_launches.values()):
                raise AssertionError(f"{what}: the CPU run launched a kernel")
            g_toks, g_steps, launches, hits = run_windows(params, cfg, DEV, card_kernels, kind,
                                                          prompts)
            prefill = [0, WINDOW_NEW + 1]
            scale = c_steps[prefill].abs().max().item()
            err = (g_steps[prefill] - c_steps[prefill]).abs().max().item()
            part, gap = first_parting(g_toks, c_toks, c_steps)
            row = {"phase": "window_parity", "arms": arms, "kv": str(kind), "layers": 2,
                   "page_size": 16, "prefill_chunk": 64, "prefix_hit_pages": hits,
                   "prefill_max_abs_logit_err": err, "prefill_max_abs_logit": scale,
                   "prefill_err_over_max_logit": err / scale, "gpu_tokens": g_toks,
                   "cpu_tokens": c_toks, "first_differing_token": part,
                   "cpu_top2_gap_over_max_logit": gap, "launches": launches, "card": card}
            if launches["paged_attention_window"] == 0 or hits == 0:
                raise AssertionError(f"{what}: no tensor-core window launch or no prefix hit")
            if not torch.isfinite(g_steps).all():
                raise AssertionError(f"{what}: non-finite logits on the card")
            if arms == "exact":
                row["tol_over_max_logit"] = LOGIT_TOL_EXACT
                log(json.dumps(row))
                if err > LOGIT_TOL_EXACT * scale or part is not None:
                    raise AssertionError(f"{what}: card and CPU differ: {row}")
                rows.append(row)
                continue
            f_toks, f_steps, f_launches, _ = run_windows(params, cfg, DEV, card_kernels, kind,
                                                         prompts, forced=c_toks)
            with windows_on_cuda_cores():
                cc_toks, _, cc_launches, _ = run_windows(params, cfg, DEV, card_kernels, kind,
                                                         prompts)
            cc_part, cc_gap = first_parting(cc_toks, c_toks, c_steps)
            f_scale = c_steps.abs().max().item()
            f_err = (f_steps - c_steps).abs().max().item()
            row.update({
                "tol_over_max_logit": LOGIT_TOL, "forced_max_abs_logit_err": f_err,
                "forced_max_abs_logit": f_scale, "forced_err_over_max_logit": f_err / f_scale,
                "forced_steps": len(f_toks),
                "forced_argmax_differs_at": [i for i, (a, b) in enumerate(zip(f_toks, c_toks))
                                             if a != b],
                "cuda_cores_gpu_tokens": cc_toks, "cuda_cores_first_differing_token": cc_part,
                "cuda_cores_cpu_top2_gap_over_max_logit": cc_gap,
                "cuda_cores_launches": cc_launches})
            log(json.dumps(row))
            if not torch.isfinite(f_steps).all() or f_err > LOGIT_TOL * f_scale:
                raise AssertionError(f"{what}: teacher-forced logits differ: {row}")
            if f_launches["paged_attention_window"] == 0:
                raise AssertionError(f"{what}: the teacher-forced run took no tensor-core window")
            if cc_launches["paged_attention_window"] or not cc_launches["paged_attention_multi"]:
                raise AssertionError(f"{what}: the CUDA-core run did not take the CUDA cores")
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phases 12a and 12b: an HF checkpoint directory in, converted and served
# ---------------------------------------------------------------------------

HF_SHARD_12A = 400_000_000   # bytes a shard (12a): a layer's linears span two shards
HF_SHARD_12B = 1_000_000_000  # 12b
HF_CALIB = (4, 128)           # 12a (iv): calibration windows x tokens, ids from the seed
HF_SCALES = ("low_scale", "low_mean", "high_scale", "high_zero")
# runs the command in its arguments and prints its peak resident memory: a
# child forked from this process would count this process's memory as its own
PEAK_RSS = ("import resource, subprocess, sys; rc = subprocess.call(sys.argv[1:]); "
            "print('peak_rss_kb', resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss); "
            "sys.exit(rc)")


def hf_dir(root: str, layers: int, seed: int, shard_bytes: int):
    """llama-7b's published config (`huggyllama/llama-7b`) cut to ``layers``
    layers, untied head, dense N(0, 0.02) weights and norms 1 + N(0, 0.01²)
    from a seeded generator on the card, written as an HF directory of fp16
    `pytorch_model-0000k-of-0000n.bin` shards of at most ``shard_bytes``
    (`data.synthetic.write_hf_checkpoint`: `hf_export.llama_to_state_dict`,
    torch alone) under a name with "llama" (`family_for` reads the name).
    Returns (cfg, params on the card, directory, write seconds)."""
    import os

    from pb_llm_tpu_torch.data.synthetic import write_hf_checkpoint
    from pb_llm_tpu_torch.models.llama import init_params

    cfg = llama7b(layers)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    params = init_params(cfg, gen, device=DEV)

    def noisy(v):
        return 1.0 + 0.01 * torch.randn(v.shape, generator=gen, device=DEV)

    for lp in params["layers"]:
        lp["input_layernorm"] = noisy(lp["input_layernorm"])
        lp["post_attention_layernorm"] = noisy(lp["post_attention_layernorm"])
    params["norm"] = noisy(params["norm"])
    d = os.path.join(root, f"llama-7b-{layers}layers")
    t0 = time.perf_counter()
    write_hf_checkpoint(params, cfg, "llama", d, dtype=torch.float16, max_shard_bytes=shard_bytes)
    return cfg, params, d, time.perf_counter() - t0


def dir_bytes(d: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def ulps_apart(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between two f32 tensors in units in the last
    place (0 for equal values, ±0 included)."""
    def ordered(x):
        i = x.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def assert_same_config(cfg, want, what: str) -> None:
    """``cfg`` (from config.json) equals ``want`` field for field, with
    num_key_value_heads resolved as `transformers` resolves it (to the head
    count where the config omits it)."""
    import dataclasses

    if dataclasses.replace(cfg, num_key_value_heads=want.num_key_value_heads) != want or \
            cfg.kv_heads != want.kv_heads:
        raise AssertionError(f"{what}: config {cfg} is not {want}")


def hf_steps(params, cfg, dev, kernels=None, forced=None, on_forward=None, **ecfg_kw):
    """Phase 12a's engine (2 slots, strips, buckets 64 and 256): a 40-token
    prompt prefilled into slot 0, then 7 decode steps, greedy or
    teacher-forced on ``forced`` (another run's tokens); then a 70-token
    prompt in slot 1 and its teacher-forced NLL over 4 tokens.  Returns the
    argmax of every step of slot 0 (the prefill's and 7 decode steps'),
    their logits and the NLL.  ``on_forward`` sees every forward."""
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    eng = Engine(params, cfg, family_for("llama"),
                 EngineConfig(n_slots=2, max_seq=256, prefill_buckets=(64, 256), kernels=kernels,
                              **ecfg_kw), device=dev)
    if on_forward is not None:
        count_forwards(eng, on_forward)
    seen = []
    step = eng._step_logits

    def recorded():
        out = step()
        seen.append(out[0].float().cpu().clone())
        return out

    eng._step_logits = recorded
    rng = np.random.default_rng(3)
    eng.prefill(0, rng.integers(0, cfg.vocab_size, 40).tolist())
    steps = [eng._prefill_logits[0].float().cpu()]
    if forced is None:
        for _ in range(7):
            eng.decode_step()
    else:
        eng.forced_decode_nll(0, forced[:8])
    steps += seen[:7]
    eng.prefill(1, rng.integers(0, cfg.vocab_size, 70).tolist())
    nll = eng.forced_decode_nll(1, rng.integers(0, cfg.vocab_size, 4).tolist())
    if dev == DEV:
        torch.cuda.synchronize()
    return [int(x.argmax()) for x in steps], torch.stack(steps), nll


def serve_artifact(packed, cfg) -> dict:
    """Phase 12a (iii): ``packed`` on the card (kernels) against the CPU
    (plain versions), under phase 3's bounds.  Exact arms (decode_dot f32,
    the hybrid prefill): greedy tokens equal, logits within
    LOGIT_TOL_EXACT, NLL within NLL_RTOL, the f32 arms launched.  Int8 arms
    (the serving defaults, int8 strips): prefill logits within LOGIT_TOL,
    NLL within NLL_RTOL, launches by arm matched to the forwards run.  A
    last-bit difference between the devices moves an int8 rounding of x,
    and the layers' int8 roundings carry it to the scale of the int8 arms'
    own error (Queue 3), so where the random model's top two logits lie
    within 2·LOGIT_TOL of max|logit| the greedy streams may part there (the
    CPU's gap is logged).  The card is then run teacher-forced on the CPU's
    tokens on both arms: its int8 logits must lie no farther from its exact
    logits (the reference, held to the CPU above) than twice as far as the
    CPU's int8 logits do, at every step."""
    from pb_llm_tpu_torch.ops import packed_matmul as pm
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig

    out = {}
    arm_kws = {"exact": dict(decode_dot="f32", prefill="hybrid"),
               "int8": dict(decode_dot="int8", prefill="int8")}
    for arms, arm_kw in arm_kws.items():
        what = f"phase 12a (iii, {arms} arms)"
        plain = KernelConfig(backend="pallas_interpret", decode_attention="pallas_interpret",
                             **arm_kw)
        t0 = time.perf_counter()
        c_toks, c_steps, c_nll = hf_steps(packed, cfg, "cpu", plain, cache_dtype=torch.int8)
        cpu_s = time.perf_counter() - t0
        fwds = []
        zero_counters()
        t0 = time.perf_counter()
        g_toks, g_steps, g_nll = hf_steps(
            packed, cfg, DEV, KernelConfig(**arm_kw),
            on_forward=lambda kind, rows, *_: fwds.append((kind or "prefill", rows)))
        gpu_s = time.perf_counter() - t0
        launches = read_counters()
        scale = c_steps[0].abs().max().item()
        err = (g_steps[0] - c_steps[0]).abs().max().item()
        part, gap = first_parting(g_toks, c_toks, c_steps)
        row = {"phase": "hf_serve_parity", "arms": arms, "kv": "int8 strips",
               "prefill_max_abs_logit_err": err, "prefill_max_abs_logit": scale,
               "prefill_err_over_max_logit": err / scale, "gpu_tokens": g_toks,
               "cpu_tokens": c_toks, "first_differing_token": part,
               "cpu_top2_gap_over_max_logit": gap, "gpu_nll": g_nll, "cpu_nll": c_nll,
               "gpu_s": gpu_s, "cpu_s": cpu_s,
               "launches": {k: v for k, v in launches.items() if v}}
        if not (np.isfinite(g_nll) and torch.isfinite(g_steps).all()):
            raise AssertionError(f"{what}: non-finite GPU output")
        if abs(g_nll - c_nll) > NLL_RTOL * abs(c_nll):
            raise AssertionError(f"{what}: NLL {g_nll} vs {c_nll}")
        if arms == "exact":
            row["tol_over_max_logit"] = LOGIT_TOL_EXACT
            log(json.dumps(row))
            if err > LOGIT_TOL_EXACT * scale or part is not None:
                raise AssertionError(f"{what}: card and CPU differ: {row}")
            if not (launches["pb_f32_matmul_split"] and launches["pb_f32_matmul_tc"]):
                raise AssertionError(f"{what}: an f32 matmul arm never launched {launches}")
            out[arms] = row
            continue
        by_arm = int8_launches([m for _, m in fwds], 14, first_linear(packed))
        mm = sum(by_arm.values())
        att = cfg.num_hidden_layers * sum(k == "decode" for k, _ in fwds)
        want = expect_launches(**by_arm, pb_prep_int8=mm, **attention_launches(att))
        f_toks, f_steps, _ = hf_steps(packed, cfg, DEV, KernelConfig(**arm_kw), forced=c_toks)
        _, e_steps, _ = hf_steps(packed, cfg, DEV, KernelConfig(**arm_kws["exact"]),
                                 forced=c_toks)
        f_scale = c_steps.abs().max().item()
        f_err = (f_steps - c_steps).abs().max().item()
        card_off = (f_steps - e_steps).abs().max().item()
        cpu_off = (c_steps - e_steps).abs().max().item()
        row.update({"tol_over_max_logit": LOGIT_TOL, "forced_max_abs_logit_err": f_err,
                    "forced_max_abs_logit": f_scale, "forced_err_over_max_logit": f_err / f_scale,
                    "forced_argmax_differs_at": [i for i, (a, b) in enumerate(zip(f_toks, c_toks))
                                                 if a != b],
                    "card_int8_from_exact_over_max_logit": card_off / f_scale,
                    "cpu_int8_from_exact_over_max_logit": cpu_off / f_scale,
                    "matmul_launches_by_arm": by_arm, "attention_launches": att,
                    "M_TC": pm.M_TC, "DECODE_ARM": pm.DECODE_ARM})
        log(json.dumps(row))
        if err > LOGIT_TOL * scale:
            raise AssertionError(f"{what}: prefill logits differ by {err} > {LOGIT_TOL} * {scale}")
        if part is not None and gap > 2 * LOGIT_TOL:
            raise AssertionError(f"{what}: the streams part at token {part}, where the CPU's top "
                                 f"two logits lie {gap} of max|logit| apart > 2 * {LOGIT_TOL}")
        if not torch.isfinite(f_steps).all() or card_off > 2 * cpu_off:
            raise AssertionError(f"{what}: the card's int8 logits lie {card_off} from its exact "
                                 f"ones, the CPU's {cpu_off}: {row}")
        if launches != want or not (by_arm["pb_int8_matmul_split"]
                                    and by_arm["pb_int8_matmul_tc"]):
            raise AssertionError(f"{what}: launches {launches}, expected {want}")
        out[arms] = row
    return out


def hf_parity(card: str) -> dict:
    """Phase 12a: an HF directory of 2 full-width llama-7b layers (fp16
    shards of at most 400 MB) on the card against the CPU.  (i) import:
    `hf_import.from_pretrained` gives family "llama", llama7b(2)'s config
    and every weight bit for bit the fp16 value written, widened; (ii)
    conversion: `cli.convert.main` on the card (RTN, xnor, low_frac 0.9,
    packed_v2) writes 14 linears, and `rtn_pack_fn` on the card applied to
    the imported weights gives the artifact's planes, codes and salient
    columns bit for bit, its scales within one f32 ulp; (iii) serving: the
    artifact installed over the imported params on the card (kernels)
    against the CPU (plain versions) under phase 3's bounds, on the exact
    and the int8 arms (`serve_artifact`); (iv) streamed GPTQ-PB
    (`quantize_model_ptq_streamed`) against the resident pipeline on the
    card: masks, planes and codes bit for bit, errors within rtol 1e-5, one
    layer resident at a time."""
    import os
    import shutil
    import tempfile

    from pb_llm_tpu_torch.calib.pipeline import quantize_model_ptq, quantize_model_ptq_streamed
    from pb_llm_tpu_torch.calib.solver import SolverConfig
    from pb_llm_tpu_torch.cli import convert
    from pb_llm_tpu_torch.core.pbw import install_pbw, load_pbw
    from pb_llm_tpu_torch.interop import to_device
    from pb_llm_tpu_torch.models import hf_import, hf_stream
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops import packed_matmul as pm

    root = tempfile.mkdtemp(prefix="pb_hf_12a_")
    try:
        cfg, written, d, write_s = hf_dir(root, 2, 20, HF_SHARD_12A)
        with open(os.path.join(d, "pytorch_model.bin.index.json")) as fh:
            shards = len(set(json.load(fh)["weight_map"].values()))

        # (i) import
        t0 = time.perf_counter()
        params, hcfg, famname = hf_import.from_pretrained(d)
        import_s = time.perf_counter() - t0
        if famname != "llama":
            raise AssertionError(f"phase 12a (i): family {famname!r}")
        assert_same_config(hcfg, cfg, "phase 12a (i)")
        n_tensors = 0

        def same(ref, got, path):
            nonlocal n_tensors
            if isinstance(ref, dict):
                for k in ref:
                    same(ref[k], got[k], f"{path}/{k}")
            elif isinstance(ref, list):
                for i, (r, g) in enumerate(zip(ref, got)):
                    same(r, g, f"{path}/{i}")
            elif ref is not None:
                n_tensors += 1
                if got.dtype != torch.float32 or not torch.equal(ref.half().float().cpu(), got):
                    raise AssertionError(f"phase 12a (i): {path} is not the fp16 value written")

        same(written, params, "params")
        del written
        torch.cuda.empty_cache()

        # (ii) conversion on the card, and the same packer in memory
        out = os.path.join(root, "pbw")
        t0 = time.perf_counter()
        if convert.main([d, out, "--family", "llama"]) != 0:
            raise AssertionError("phase 12a (ii): convert failed")
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t0
        layers, extra = load_pbw(out)
        if len(layers) != 14 or extra.get("family") != "llama":
            raise AssertionError(f"phase 12a (ii): {len(layers)} linears, {extra}")
        pack = hf_stream.rtn_pack_fn()
        scale_ulps, arms = 0, {}
        for key, got in layers.items():
            i, name = int(key.split("/")[0][6:]), key.split("/")[1]
            want = pack(name, params["layers"][i][name]["w"].T, None)
            for f in ("sign_packed", "side_val", "side_idx"):
                if not torch.equal(getattr(got, f), getattr(want, f).cpu()):
                    raise AssertionError(f"phase 12a (ii): {key} {f} differs from the packer's")
            scale_ulps = max(scale_ulps, *(ulps_apart(getattr(got, f), getattr(want, f).cpu())
                                           for f in HF_SCALES))
            arms[name] = {"tc_layout_ok": pm.tc_layout_ok(got), "decode": pm.int8_arm(2, got),
                          "prefill": [pm.int8_arm(m, got) for m in (64, 256)]}
        if scale_ulps > 1:
            raise AssertionError(f"phase 12a (ii): scales {scale_ulps} ulps from the packer's")
        log(json.dumps({"phase": "hf_arms", "by_linear": arms}))

        # (iii) the artifact served on the card against the CPU
        packed = install_pbw(params, layers)
        served = serve_artifact(packed, cfg)
        del packed

        # (iv) streamed GPTQ-PB against the resident pipeline, on the card
        calib = np.random.default_rng(21).integers(0, cfg.vocab_size, HF_CALIB)
        scfg = SolverConfig(low_frac=0.9, salient_metric="hessian", mask_structure="column",
                            col_tile=0)
        fam = family_for("llama")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resident, rep_res = quantize_model_ptq(to_device(params, DEV), cfg, fam, calib, scfg,
                                               fmt="packed_v2", log=None)
        torch.cuda.synchronize()
        resident_s = time.perf_counter() - t0
        del params
        loader = hf_stream.StreamedLayerLoader(d, "llama")
        t0 = time.perf_counter()
        rep_st = quantize_model_ptq_streamed(loader, cfg, fam, calib, scfg,
                                             os.path.join(root, "gptq"), log=None)
        torch.cuda.synchronize()
        streamed_s = time.perf_counter() - t0
        streamed, _ = load_pbw(os.path.join(root, "gptq"))
        apart = [k for k in rep_res.masks if not np.array_equal(rep_res.masks[k], rep_st.masks[k])]
        apart += [f"{k}:{f}" for k, p in streamed.items()
                  for f in ("sign_packed", "side_val", "side_idx")
                  if not torch.equal(getattr(p, f),
                                     getattr(resident["layers"][int(k.split("/")[0][6:])]
                                             [k.split("/")[1]], f).cpu())]
        err_rel = max(abs(rep_res.errors[k] - rep_st.errors[k]) / max(abs(rep_res.errors[k]), 1e-30)
                      for k in rep_res.errors)
        del resident
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    row = {"phase": "hf_parity", "model": "llama-7b config (huggyllama/llama-7b), 2 layers, "
           "random dense fp16 weights", "shards": shards, "write_s": write_s,
           "from_pretrained_s": import_s, "tensors_bit_for_bit": n_tensors,
           "convert_s": convert_s, "linears": len(layers), "scale_ulps_apart": scale_ulps,
           "serve_first_differing_token": served["int8"]["first_differing_token"],
           "matmul_launches_by_arm": served["int8"]["matmul_launches_by_arm"],
           "attention_launches": served["int8"]["attention_launches"],
           "gptq_resident_s": resident_s, "gptq_streamed_s": streamed_s,
           "gptq_peak_resident_layers": loader.max_live, "gptq_apart": apart,
           "gptq_error_max_rel_diff": err_rel, "card": card}
    log(json.dumps(row))
    if apart or err_rel > 1e-5 or loader.max_live != 1:
        raise AssertionError(f"phase 12a (iv): streamed differs from resident: {apart}, "
                             f"errors {err_rel}, peak layers {loader.max_live}")
    return row


def hf_e2e(card: str) -> dict:
    """Phase 12b: convert, then serve.  The llama-7b config cut to 8 full
    layers, fp16 shards of at most 1 GB in a temporary directory (its free
    bytes printed first; both directories removed at the end); `python -m
    pb_llm_tpu_torch.cli.convert` as a subprocess (the real entry point, on
    the card), timed, its peak resident memory read (`PEAK_RSS`); then
    `from_pretrained` + `load_pbw` + `install_pbw` and phase 4's 16 requests
    of 32 new tokens through `ContinuousBatcher` on `Engine(n_slots=8,
    max_seq=2048)`, graphed, token ids in directly, every launch counter
    matched to the forwards run as in phase 4."""
    import os
    import shutil
    import tempfile

    from pb_llm_tpu_torch.core.pbw import install_pbw, load_pbw
    from pb_llm_tpu_torch.models import hf_import
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    root = tempfile.mkdtemp(prefix="pb_hf_12b_")
    try:
        free = shutil.disk_usage(root).free
        log(json.dumps({"phase": "hf_e2e_disk", "dir": root, "free_bytes": free}))
        cfg, written, d, write_s = hf_dir(root, 8, 22, HF_SHARD_12B)
        del written
        torch.cuda.empty_cache()
        on_disk = dir_bytes(d)
        out = os.path.join(root, "pbw")
        cmd = [sys.executable, "-c", PEAK_RSS, sys.executable, "-m", "pb_llm_tpu_torch.cli.convert",
               d, out, "--family", "llama"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        convert_wall_s = time.perf_counter() - t0
        text = proc.stdout + proc.stderr
        log(text.rstrip())
        done = [ln for ln in text.splitlines() if ln.startswith("packed ")]
        if proc.returncode != 0 or not done or not done[-1].startswith("packed 56 linears"):
            raise AssertionError(f"phase 12b: convert exited {proc.returncode}: {text[-2000:]}")
        convert_s = float(done[-1].rsplit(" in ", 1)[1].rstrip("s"))
        peak_rss_kb = int(text.rsplit("peak_rss_kb ", 1)[1].split()[0])

        t0 = time.perf_counter()
        params, hcfg, _ = hf_import.from_pretrained(d)
        import_s = time.perf_counter() - t0
        assert_same_config(hcfg, cfg, "phase 12b")
        t0 = time.perf_counter()
        layers, _ = load_pbw(out)
        load_s = time.perf_counter() - t0
        params = install_pbw(params, layers)
        del layers
        p0 = first_linear(params)
        n_linear = sum(1 for lp in params["layers"] for v in lp.values() if hasattr(v, "sign_packed"))
        plane_bytes = sum(packed_bytes(v) for lp in params["layers"] for v in lp.values()
                          if hasattr(v, "sign_packed"))
        eng = Engine(params, hcfg, family_for(os.path.basename(d)),
                     EngineConfig(n_slots=8, max_seq=2048), device=DEV)
        del params
    finally:
        shutil.rmtree(root, ignore_errors=True)
    reqs = e2e_requests(cfg.vocab_size)
    batcher, launches, fwds, step_ms, kv_rows, prefill_ms = run_counted(eng, reqs)
    forwards = {kind: sum(k == kind for k, _ in fwds) for kind in ("prefill", "decode")}
    by_arm = int8_launches([m for _, m in fwds], n_linear, p0)
    mm, att = sum(by_arm.values()), launches["decode_attention"]
    want = expect_launches(**by_arm, pb_prep_int8=mm, **attention_launches(att))
    s = batcher.stats
    row = {"phase": "hf_e2e", "model": "llama-7b config (huggyllama/llama-7b), 8 layers, random "
           "dense fp16 weights -> cli.convert (RTN xnor, low_frac 0.9, packed_v2)",
           "bytes_on_disk": on_disk, "free_bytes_before": free, "write_s": write_s,
           "convert_wall_s": convert_wall_s, "convert_s": convert_s,
           "convert_s_per_layer": convert_s / cfg.num_hidden_layers,
           "convert_peak_rss_gb": peak_rss_kb * 1024 / 1e9,
           "layer_f32_bytes": 4 * sum(a * b for a, b in (
               (cfg.hidden_size, cfg.hidden_size),) * 4 + ((cfg.hidden_size,
                                                            cfg.intermediate_size),) * 3),
           "from_pretrained_s": import_s, "load_pbw_s": load_s, "linears": n_linear,
           "requests": len(reqs), "generated_tokens": s.generated_tokens,
           "wall_s": s.wall_seconds, "tokens_per_s": s.tokens_per_second,
           "decode_steps": len(step_ms), "ms_per_decode_step_median": statistics.median(step_ms),
           "ms_per_decode_step_mean": statistics.mean(step_ms),
           "prefill_forwards": forwards["prefill"], "decode_forwards": forwards["decode"],
           "prefill_ms_total": sum(prefill_ms), "matmul_launches": mm,
           "matmul_launches_by_arm": by_arm, "prep_launches": launches["pb_prep_int8"],
           "attention_launches": att, "attention_split_launches": launches["decode_attention_split"],
           "packed_plane_bytes": plane_bytes, "graph_replays": eng._step.replays,
           "graph_replay_device_ms": replay_ms(eng), "card": card}
    row["graph_idle_share"] = 1 - row["graph_replay_device_ms"] / row["ms_per_decode_step_median"]
    log(json.dumps(row))
    if mm != n_linear * (forwards["prefill"] + forwards["decode"]) or mm == 0:
        raise AssertionError(f"phase 12b: {mm} matmul launches for {forwards} forwards")
    if att != cfg.num_hidden_layers * forwards["decode"] or att == 0:
        raise AssertionError(f"phase 12b: {att} attention launches for {forwards} forwards")
    if launches != want:
        raise AssertionError(f"phase 12b: launches {launches}, expected {want}")
    if eng._step.replays == 0:
        raise AssertionError("phase 12b: the graphed pass replayed no graph")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true", help="trace three decode steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from pb_llm_tpu_torch.data.synthetic import random_packed_llama, random_packed_opt
    from pb_llm_tpu_torch.ops import decode_arms as da
    from pb_llm_tpu_torch.ops import packed_matmul as pm
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1
    from pb_llm_tpu_torch.ops import paged_attention as tpa

    card = setup()
    timer = Timer()
    mm_rows = check_matmul(timer, card)
    prep_rows = check_prep(timer, card)
    att_rows = check_attention(timer, card)
    att = att_rows[0]
    dq_rows = check_dequant(timer, card)
    f32_rows = check_f32_matmul(timer, card)
    f32_split_rows = check_f32_split(timer, card)
    fa_rows = check_flash(timer, card)
    pa_rows = check_paged_attention(timer, card)
    v1_rows = check_v1_matmul(timer, card)
    pair_rows = check_pair_arms(timer, card)
    dma_rows = check_dma_arms(timer, card)
    dma_prep = check_dma_prep(timer, card)
    arm_rows = check_v2_arms(timer, card)
    del timer
    parity_params = random_packed_llama(llama7b(2), torch.Generator().manual_seed(4))
    check_engine_parity(parity_params, "int8")
    exact = check_engine_parity(parity_params, "exact")
    t0 = time.perf_counter()
    params = random_packed_llama(llama7b(32), torch.Generator(device=DEV).manual_seed(5))
    torch.cuda.synchronize()
    e2e = serve_e2e(params, time.perf_counter() - t0, card, args.profile)
    check_engine_parity(parity_params, "int8", page_size=16)
    paged_invariants(parity_params, card)
    scan_fuse = scan_fuse_parity(parity_params, card)
    check_kv_parity(parity_params, card)
    graph_parity(parity_params, card)
    window_parity(parity_params, card)
    del parity_params
    paged = paged_e2e(params, card)
    arms_e2e = serve_scan_fuse_e2e(params, card)
    http_e2e = serve_http_e2e(params, card, e2e)
    del params
    torch.cuda.empty_cache()
    check_opt_parity(card)
    t0 = time.perf_counter()
    opt_params = random_packed_opt(opt13b(24), torch.Generator(device=DEV).manual_seed(18))
    torch.cuda.synchronize()
    v1_e2e = serve_v1_e2e(opt_params, opt13b(24), time.perf_counter() - t0, card)
    del opt_params
    torch.cuda.empty_cache()
    hf = hf_parity(card)
    hf_serve = hf_e2e(card)
    prod = producer(card)
    prod_v1 = producer_v1(card)

    at_head = {r["arm"]: r for r in mm_rows if (r["m"], r["ic"], r["oc"]) == HEADLINE_SHAPE}
    head, split = at_head["dp4a"], at_head["split"]
    pre = {r["arm"]: r for r in mm_rows if (r["m"], r["ic"], r["oc"]) == PREFILL_SHAPE}
    dq = next(r for r in dq_rows if (r["ic"], r["oc"], r["dtype"]) == (4096, 11008, "torch.float32"))
    f32 = next(r for r in f32_rows if (r["m"], r["ic"], r["oc"]) == HEADLINE_SHAPE
               and r["arm"] == "cores")
    f32s = next(r for r in f32_split_rows if (r["m"], r["ic"], r["oc"]) == HEADLINE_SHAPE)
    f32_pre = {r["arm"]: r for r in f32_rows
               if (r["m"], r["ic"], r["oc"]) == PREFILL_SHAPE and r["col_tile"] == r["oc"]}
    fa = fa_rows[0]
    pa = next(r for r in pa_rows if r["case"] == "decode_int8")
    paged_by_arm = {a: sum(r["launches"][f"paged_attention_{a}"] for r in paged)
                    for a in ("split", "cuda_cores", "window")}
    planar = next(r for r in v1_rows if r["kernel"] == "pb_planar_v1" and (r["ic"], r["oc"]) ==
                  V1_HEADLINE and r["groupsize"] == V1_HEADLINE[0] and r["sidecar_bits"] == 8
                  and r["low_bits"] == 1 and r["m"] == 8)
    planar_launches = {a: v1_e2e["launches"][k] for a, k in PLANAR_COUNTERS.items()}
    select = next(r for r in v1_rows if r["kernel"] == "pb_select_v1" and (r["ic"], r["oc"]) ==
                  V1_HEADLINE and r["groupsize"] == 128 and r["dot"] == "torch.float32")
    select_launches = {a: v1_e2e["launches"][k] + prod_v1["launches"][k]
                       for a, k in (("cores", "pb_select_v1"), ("tc", "pb_select_v1_tc"))}
    flash_launches = {a: prod["launches"][k] + prod_v1["launches"][k]
                      for a, k in (("cores", "flash_attention"), ("tc", "flash_attention_tc"))}
    # the int8 arms, strip attention's split arm and the x preparation: phase
    # 4's launches and those of phases 12a (iii) and 12b
    int8_by_arm = {k: e2e["matmul_launches_by_arm"][k] + hf["matmul_launches_by_arm"][k]
                   + hf_serve["matmul_launches_by_arm"][k] for k in e2e["matmul_launches_by_arm"]}
    att_split = (e2e["attention_split_launches"] + hf["attention_launches"]
                 + hf_serve["attention_split_launches"])
    kernels = [
        {"name": "pb_int8_matmul", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/pb_int8_matmul.cu",
         "replaces": "pb_llm_tpu/ops/pallas_pb.py:393", "launches": sum(int8_by_arm.values()),
         "max_abs_err": max(r["max_abs_err"] for r in mm_rows), "ms": head["kernel_ms"],
         "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
         "library_ms": head["library_ms"], "parity": "bit for bit", "arm": "dp4a",
         "arm_launches": int8_by_arm,
         "shape": "m={} ic={} oc={} low_frac 0.9; the dp4a arm; launches: phases 4, 12a and "
                  "12b, every arm".format(*HEADLINE_SHAPE),
         "prefill": {k: pre["tc"][k] for k in ("m", "ic", "oc", "arm", "kernel_ms", "bound_ms",
                                              "bound_by", "plain_ms", "library_ms")}
         | {"dp4a_ms": pre["dp4a"]["kernel_ms"], "M_TC": pm.M_TC}},
        {"name": "pb_int8_matmul_split", "route": "cuda",
         "source": "pb_llm_tpu_torch/csrc/pb_int8_matmul.cu",
         "replaces": "pb_llm_tpu/ops/pallas_pb.py:393",
         "launches": int8_by_arm["pb_int8_matmul_split"],
         "max_abs_err": max(r["max_abs_err"] for r in mm_rows if r["arm"] == "split"),
         "ms": split["kernel_ms"], "plain_ms": split["plain_ms"], "bound_ms": split["bound_ms"],
         "bound_by": split["bound_by"], "library_ms": split["library_ms"], "parity": "bit for bit",
         "arm": "split", "dp4a_ms": head["kernel_ms"], "tc_ms": at_head["tc"]["kernel_ms"],
         "ksplit": split["ksplit"], "DECODE_ARM": pm.DECODE_ARM,
         "shape": "m={} ic={} oc={} low_frac 0.9; int8 tensor cores (split_kernel: wgmma, TMA, "
                  "the K stages in ksplit ranges, a cluster a tile); launches: phases 4, 12a "
                  "and 12b".format(*HEADLINE_SHAPE)},
        {"name": "decode_attention", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/decode_attention.cu",
         "replaces": "pb_llm_tpu/ops/decode_attention.py:78",
         "launches": e2e["attention_launches"] - e2e["attention_split_launches"],
         "yardstick": True, "max_abs_err": att["slot_max_abs_err"], "ms": att["slot_ms"],
         "plain_ms": att["plain_ms"],
         "bound_ms": att["bound_ms"], "bound_by": att["bound_by"], "library_ms": att["library_ms"],
         "parity": "ok", "arm": "slot",
         "arm_launches": {"split": att_split,
                          "slot": e2e["attention_launches"] - e2e["attention_split_launches"]},
         "shape": "B={} S={} Hq={} Hkv={} D={} int8".format(*ATTN_SHAPE)
         + f", lengths <= {ATTN_MAX_LEN}; the slot arm (a block a slot and head, only a call "
           "that names it); launches: phase 4, the slot arm's (both in arm_launches, the "
           "split arm's with phases 12a and 12b)"},
        {"name": "decode_attention_split", "route": "cuda",
         "source": "pb_llm_tpu_torch/csrc/decode_attention.cu",
         "replaces": "pb_llm_tpu/ops/decode_attention.py:78",
         "launches": att_split, "max_abs_err": att["max_abs_err"],
         "ms": att["kernel_ms"], "plain_ms": att["plain_ms"], "bound_ms": att["bound_ms"],
         "bound_by": att["bound_by"], "library_ms": att["library_ms"], "parity": "ok",
         "arm": "split", "slot_ms": att["slot_ms"],
         "shape": "B={} S={} Hq={} Hkv={} D={} int8".format(*ATTN_SHAPE)
         + f", lengths <= {ATTN_MAX_LEN}; the split arm (64 rows a block, a merge launch; "
           "the time covers both); library: SDPA bf16; launches: phases 4, 12a and 12b"},
        {"name": "pb_dequant_v2", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/pb_dequant_v2.cu",
         "replaces": "pb_llm_tpu/ops/pallas_pb.py:625", "launches": prod["launches"]["pb_dequant_v2"],
         "max_abs_err": max(r["max_abs_err"] for r in dq_rows), "ms": dq["kernel_ms"],
         "plain_ms": dq["plain_ms"], "bound_ms": dq["bound_ms"], "bound_by": dq["bound_by"],
         "library_ms": None, "parity": "bit for bit", "shape": "ic=4096 oc=11008 f32 out"},
        {"name": "pb_f32_matmul", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/pb_f32_matmul.cu",
         "replaces": "pb_llm_tpu/ops/pallas_pb.py:297",
         "launches": exact["f32_matmul_launches"]["cores"], "yardstick": True,
         "max_abs_err": max(r["max_abs_err"] for r in f32_rows if r["arm"] == "cores"),
         "ms": f32["kernel_ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
         "bound_by": f32["bound_by"], "library_ms": f32["library_ms"], "parity": "ok",
         "arm": "cores", "F32_TC": pm.F32_TC, "arm_launches": exact["f32_matmul_launches"],
         "shape": "m={} ic={} oc={} low_frac 0.9, global selection; the f32 CUDA cores (2- and "
                  "4-bit lows, dot bf16 below F32_TC, layouts the tensor cores refuse, or a "
                  "call that names it); launches: phase 3 (exact arms), the cores arm's (every "
                  "arm in arm_launches)".format(*HEADLINE_SHAPE)},
        {"name": "pb_f32_matmul_split", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/pb_dma_v2.cu",
         "replaces": "pb_llm_tpu/ops/pallas_pb.py:297",
         "launches": exact["f32_matmul_launches"]["split"],
         "max_abs_err": max(r["split_max_abs_err"] for r in f32_split_rows),
         "ms": f32s["split_ms"], "plain_ms": f32s["plain_ms"], "bound_ms": f32s["split_bound_ms"],
         "bound_by": f32s["split_bound_by"], "library_ms": f32s["library_ms"], "parity": "ok",
         "arm": "split", "cuda_cores_ms": f32s["cores_ms"], "tc_ms": f32s["tc_ms"],
         "prep_ms": f32s["split_prep_ms"], "ksplit": f32s["ksplit"],
         "F32_DECODE_ARM": pm.F32_DECODE_ARM,
         "shape": "m={} ic={} oc={} low_frac 0.9, global selection; the dma kernel's split "
                  "device code (entry pb_dma_v2_split: wgmma bf16, x in 3 exact terms stacked as "
                  "N = 24, a K split in a cluster); library: f32 matmul on the dense weight; "
                  "launches: phase 3 (exact arms)".format(*HEADLINE_SHAPE)},
        {"name": "pb_f32_matmul_tc", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/pb_bf16_tc.cuh",
         "replaces": "pb_llm_tpu/ops/pallas_pb.py:297",
         "launches": exact["f32_matmul_launches"]["tc"],
         "max_abs_err": max(r["max_abs_err"] for r in f32_rows if r["arm"] == "tc"),
         "ms": f32_pre["tc"]["kernel_ms"], "plain_ms": f32_pre["tc"]["plain_ms"],
         "bound_ms": f32_pre["tc"]["bound_ms"], "bound_by": f32_pre["tc"]["bound_by"],
         "library_ms": f32_pre["tc"]["library_ms"], "parity": "ok", "arm": "tc",
         "cuda_cores_ms": f32_pre["cores"]["kernel_ms"], "prep_ms": f32_pre["tc"]["prep_ms"],
         "cuda_cores_bound_ms": f32_pre["tc"]["cuda_cores_bound_ms"],
         "shape": "m={} ic={} oc={} low_frac 0.9, global selection; bf16 tensor cores, x in 3 "
                  "terms (entry pb_f32_matmul_tc in pb_f32_matmul.cu); library: f32 matmul, TF32 "
                  "off; launches: phase 3 (exact arms)".format(*PREFILL_SHAPE)},
        {"name": "flash_attention", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/flash_attention.cu",
         "replaces": "pb_llm_tpu/ops/flash_attention.py:29", "launches": flash_launches["cores"],
         "yardstick": True,
         "max_abs_err": max(r["cores_max_abs_err"] for r in fa_rows), "ms": fa["cores_ms"],
         "plain_ms": fa["plain_ms"], "bound_ms": fa["cores_bound_ms"],
         "bound_by": fa["cores_bound_by"], "library_ms": fa["library_ms"], "parity": "ok",
         "arm": "cores", "arm_launches": flash_launches,
         "shape": "B={} T={} H={} D={} causal f32; the f32 CUDA-core arm (only a call that "
                  "names it); launches: phases 5 and 8, the cores arm's (both in "
                  "arm_launches)".format(*FLASH_CASES[0][:4])},
        {"name": "flash_attention_tc", "route": "cuda",
         "source": "pb_llm_tpu_torch/csrc/flash_attention.cu",
         "replaces": "pb_llm_tpu/ops/flash_attention.py:29", "launches": flash_launches["tc"],
         "max_abs_err": max(r["max_abs_err"] for r in fa_rows), "ms": fa["kernel_ms"],
         "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"], "bound_by": fa["bound_by"],
         "library_ms": fa["library_ms"], "parity": "ok", "arm": "tc",
         "cuda_cores_ms": fa["cores_ms"], "cuda_cores_bound_ms": fa["cores_bound_ms"],
         "dots_bf16_ms": fa["bf16_ms"], "dots_bf16_library_ms": fa["library_bf16_ms"],
         "shape": "B={} T={} H={} D={} causal f32; bf16 tensor cores (entry flash_attention_tc: "
                  "wgmma, TMA; q, k in 3 bf16 terms, p, v in 2; 9 products), the terms launch "
                  "included; library: SDPA f32; launches: phases 5 and 8".format(
                      *FLASH_CASES[0][:4])},
        {"name": "paged_attention", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/paged_attention.cu",
         "replaces": "pb_llm_tpu/ops/paged_attention.py:35",
         "launches": paged_by_arm["cuda_cores"], "yardstick": True,
         "max_abs_err": max(r["cuda_cores_max_abs_err"] for r in pa_rows),
         "ms": pa["cuda_cores_ms"], "plain_ms": pa["plain_ms"],
         "bound_ms": pa["cuda_cores_bound_ms"], "bound_by": pa["cuda_cores_bound_by"],
         "library_ms": pa["library_ms"], "parity": "ok", "arm": "cuda_cores",
         "arm_launches": paged_by_arm,
         "shape": "B=8 Hq=Hkv=32 D=128 int8 pages of 16 (1025), lengths <= 512, decode; the "
                  "CUDA-core arm (f32-page windows, decode beyond the split arm's shapes, or a "
                  "call that names it); launches: phase 6b, the CUDA-core arm's (both decode "
                  "arms in arm_launches)"},
        {"name": "paged_attention_split", "route": "cuda",
         "source": "pb_llm_tpu_torch/csrc/paged_attention.cu",
         "replaces": "pb_llm_tpu/ops/paged_attention.py:35", "launches": paged_by_arm["split"],
         "max_abs_err": max(r["split_max_abs_err"] for r in pa_rows if "split_max_abs_err" in r),
         "ms": pa["split_ms"], "plain_ms": pa["plain_ms"], "bound_ms": pa["split_bound_ms"],
         "bound_by": pa["split_bound_by"], "library_ms": pa["library_ms"], "parity": "ok",
         "arm": "split", "cuda_cores_ms": pa["cuda_cores_ms"], "SPLIT_KEYS": tpa.SPLIT_KEYS,
         "SPLIT_GRID": tpa.SPLIT_GRID,
         "shape": "B=8 Hq=Hkv=32 D=128 int8 pages of 16 (1025), lengths <= 512, decode; 128-key "
                  "splits of whole pages, a merge launch (the time covers both); library: SDPA "
                  "bf16; launches: phase 6b"},
        {"name": "pb_planar_v1", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/pb_planar_v1.cu",
         "replaces": "pb_llm_tpu/ops/pallas_pb.py:148", "launches": planar_launches["cores"],
         "yardstick": True,
         "max_abs_err": max(r["cores_max_abs_err"] for r in v1_rows
                            if r["kernel"] == "pb_planar_v1"),
         "ms": planar["cores_ms"], "plain_ms": planar["plain_ms"],
         "bound_ms": planar["cores_bound_ms"], "bound_by": planar["cores_bound_by"],
         "library_ms": planar["library_f32_ms"], "parity": "ok", "arm": "cores",
         "arm_launches": planar_launches,
         "shape": "m=8 ic=2048 oc=8192 (OPT-1.3B fc1) low_frac 0.9, whole-row scales; the f32 "
                  "CUDA-core arm (layouts arm tc does not take, or a call that names it); library: "
                  "f32 matmul on the dense weight; launches: phase 7b, the cores arm's (both in "
                  "arm_launches)"},
        {"name": "pb_planar_v1_tc", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/pb_planar_v1.cu",
         "replaces": "pb_llm_tpu/ops/pallas_pb.py:148", "launches": planar_launches["tc"],
         "max_abs_err": max(r["tc_max_abs_err"] for r in v1_rows if r["kernel"] == "pb_planar_v1"),
         "ms": planar["tc_ms"], "plain_ms": planar["plain_ms"], "bound_ms": planar["tc_bound_ms"],
         "bound_by": planar["tc_bound_by"], "library_ms": planar["library_f32_ms"],
         "library_bf16_ms": planar["library_bf16_ms"], "parity": "ok", "arm": "tc",
         "cuda_cores_ms": planar["cores_ms"], "select_tc_ms": planar["select_tc_ms"],
         "tile": planar["tile"], "ksplit": planar["ksplit"],
         "cuda_cores_arith_ms": planar["cores_arith_ms"],
         "PLANAR_ARM": v1.PLANAR_ARM,
         "shape": "m=8 ic=2048 oc=8192 (OPT-1.3B fc1) low_frac 0.9, whole-row scales; bf16 tensor "
                  "cores (entry pb_planar_v1_tc: wgmma, TMA; C, M, V exact, x in 3 bf16 terms "
                  "stacked as N = 24, a K split in a cluster), the terms launch included; library: "
                  "f32 matmul on the dense weight; launches: phase 7b"},
        {"name": "pb_select_v1", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/pb_select_v1.cu",
         "replaces": "pb_llm_tpu/ops/pallas_pb.py:1297", "launches": select_launches["cores"],
         "yardstick": True,
         "max_abs_err": max(r["cores_max_abs_err"] for r in v1_rows if r["kernel"] == "pb_select_v1"),
         "ms": select["cores_ms"], "plain_ms": select["plain_ms"], "bound_ms": select["cores_bound_ms"],
         "bound_by": select["cores_bound_by"], "library_ms": select["library_f32_ms"],
         "parity": "ok", "arm": "cores", "arm_launches": select_launches,
         "shape": "m=512 ic=2048 oc=8192 f32, groups of 128; the f32 CUDA-core arm (below "
                  "SELECT_TC = {} rows); launches: phases 7b and 8, the cores arm's (both in "
                  "arm_launches); library: f32 "
                  "matmul on the dense weight".format(v1.SELECT_TC)},
        {"name": "pb_select_v1_tc", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/pb_select_v1.cu",
         "replaces": "pb_llm_tpu/ops/pallas_pb.py:1297", "launches": select_launches["tc"],
         "max_abs_err": max(r["tc_max_abs_err"] for r in v1_rows if r["kernel"] == "pb_select_v1"),
         "ms": select["tc_ms"], "plain_ms": select["plain_ms"], "bound_ms": select["tc_bound_ms"],
         "bound_by": select["tc_bound_by"], "library_ms": select["library_f32_ms"],
         "parity": "ok", "arm": "tc", "cuda_cores_ms": select["cores_ms"],
         "cuda_cores_bound_ms": select["cores_bound_ms"], "SELECT_TC": v1.SELECT_TC,
         "shape": "m=512 ic=2048 oc=8192 f32, groups of 128; bf16 tensor cores (entry "
                  "pb_select_v1_tc: wgmma, TMA; x and w in 3 bf16 terms, 6 products), the terms "
                  "launch included; launches: phases 7b and 8; library: f32 matmul on the dense "
                  "weight"},
    ]

    def arm_row(kernel, m=HEADLINE_SHAPE[0], **match):
        return next(r for r in arm_rows if r["kernel"] == kernel
                    and (r["m"], r["ic"], r["oc"]) == (m, *HEADLINE_SHAPE[1:])
                    and all(r.get(k) == v for k, v in match.items()))

    def e2e_launches(kernel, arms=("", "_tc")):  # the kernel's launches over its arms
        return sum(r["launches"].get(kernel + a, 0) for r in arms_e2e for a in arms)

    def pair_row(m, arm):
        return next(r for r in pair_rows if r["layer"] == "{}x{}".format(*HEADLINE_SHAPE[1:])
                    and r["m"] == m and r["arm"] == arm)

    pair_dec, pair_mma = pair_row(HEADLINE_SHAPE[0], "split"), pair_row(HEADLINE_SHAPE[0], "mma")
    pair_tc, pair_tc_mma = pair_row(128, "tc"), pair_row(128, "mma")
    kernels += [
        {"name": "pb_pair_v2", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/pb_pair_v2.cu",
         "replaces": "pb_llm_tpu/ops/pallas_pb.py:334",
         "launches": e2e_launches("pb_pair_v2", ("", "_split", "_tc")),
         "max_abs_err": max(r["max_abs_err"] for r in pair_rows), "ms": pair_dec["kernel_ms"],
         "plain_ms": pair_dec["plain_ms"], "bound_ms": pair_dec["bound_ms"],
         "bound_by": pair_dec["bound_by"], "library_ms": pair_dec["library_ms"], "parity": "ok",
         "arm": "split", "mma_ms": pair_mma["kernel_ms"], "prep_ms": pair_dec["prep_ms"],
         "PAIR_TC": da.PAIR_TC, "split_launches": e2e_launches("pb_pair_v2", ("_split",)),
         "mma_launches": e2e_launches("pb_pair_v2", ("",)),
         "shape": "m={} ic={} oc={} low_frac 0.9; the split arm (wgmma, K split over blocks; "
                  "pb_bf16_tc.cuh), the mma.sync arm's time beside; library: bf16 matmul on the "
                  "dense weight; launches: phase 9b, every arm".format(*HEADLINE_SHAPE)},
        {"name": "pb_pair_v2_tc", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/pb_bf16_tc.cuh",
         "replaces": "pb_llm_tpu/ops/pallas_pb.py:334",
         "launches": e2e_launches("pb_pair_v2", ("_tc",))
         + scan_fuse["pair_launches"]["pb_pair_v2_tc"],
         "max_abs_err": max(r["max_abs_err"] for r in pair_rows if r["arm"] == "tc"),
         "ms": pair_tc["kernel_ms"], "plain_ms": pair_tc["plain_ms"],
         "bound_ms": pair_tc["bound_ms"], "bound_by": pair_tc["bound_by"],
         "library_ms": pair_tc["library_ms"], "parity": "ok", "arm": "tc",
         "mma_ms": pair_tc_mma["kernel_ms"], "prep_ms": pair_tc["prep_ms"],
         "shape": "m=128 ic={} oc={} low_frac 0.9; wgmma and TMA, one bf16 term of x (entry "
                  "pb_pair_v2_tc in pb_pair_v2.cu); library: bf16 matmul on the dense weight; "
                  "launches: phases 9a (128-row prefill windows) and 9b (its prefill forwards "
                  "below 256 rows come in 32-row windows: split)".format(*HEADLINE_SHAPE[1:])},
    ]
    dma = next(r for r in dma_rows if (r["m"], r["ic"], r["oc"]) == HEADLINE_SHAPE)
    dma_by_arm = {"cores": e2e_launches("pb_dma_v2", ("",)),
                  "split": e2e_launches("pb_dma_v2", ("_split",))}
    kernels += [
        {"name": "pb_dma_v2", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/pb_dma_v2.cu",
         "replaces": "pb_llm_tpu/ops/pallas_pb.py:826", "launches": dma_by_arm["cores"],
         "yardstick": True,
         "max_abs_err": max(r["cores_max_abs_err"] for r in dma_rows), "ms": dma["cores_ms"],
         "plain_ms": dma["plain_ms"], "bound_ms": dma["cores_bound_ms"],
         "bound_by": dma["cores_bound_by"], "library_ms": dma["library_f32_ms"], "parity": "ok",
         "arm": "cores", "arm_launches": dma_by_arm,
         "shape": "m={} ic={} oc={} low_frac 0.9; the f32 CUDA-core arm (layouts the tensor cores "
                  "do not take, or a call that names it); library: f32 matmul on the dense "
                  "weight; launches: phase 9b, the cores arm's (both in "
                  "arm_launches)".format(*HEADLINE_SHAPE)},
        {"name": "pb_dma_v2_split", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/pb_dma_v2.cu",
         "replaces": "pb_llm_tpu/ops/pallas_pb.py:826", "launches": dma_by_arm["split"],
         "max_abs_err": max(r["split_max_abs_err"] for r in dma_rows), "ms": dma["split_ms"],
         "plain_ms": dma["plain_ms"], "bound_ms": dma["split_bound_ms"],
         "bound_by": dma["split_bound_by"], "library_ms": dma["library_f32_ms"],
         "library_bf16_ms": dma["library_bf16_ms"], "parity": "ok", "arm": "split",
         "cuda_cores_ms": dma["cores_ms"], "prep_ms": dma["split_prep_ms"],
         "ksplit": dma["ksplit"], "DMA_ARM": da.DMA_ARM,
         "shape": "m={} ic={} oc={} low_frac 0.9; bf16 tensor cores (entry pb_dma_v2_split: "
                  "wgmma, TMA; x in 3 exact bf16 terms stacked as N = 24, a K split in a "
                  "cluster); library: f32 matmul on the dense weight; launches: phase "
                  "9b".format(*HEADLINE_SHAPE)},
        {"name": "pb_prep_dma", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/pb_dma_v2.cu",
         "replaces": "pb_llm_tpu/ops/pallas_pb.py:893",
         "launches": e2e_launches("pb_prep_dma", ("",)),
         "max_abs_err": dma_prep["max_abs_err"], "ms": dma_prep["kernel_ms"],
         "plain_ms": dma_prep["plain_ms"], "bound_ms": dma_prep["bound_ms"],
         "bound_by": dma_prep["bound_by"], "library_ms": None,
         "parity": "terms bit for bit, sums within sum_bound",
         "shape": "m={} ic={} oc={}: x's and xg's three bf16 terms and row sums for arm split "
                  "(the x preparation XLA runs around the dma call); launches: phase "
                  "9b".format(*HEADLINE_SHAPE)},
    ]
    for name, replaces, source, launches, library in (
            ("pb_int8_matmul_stacked", 953, "pb_int8_matmul.cu",
             e2e_launches("pb_int8_matmul_stacked", ("", "_tc", "_split")), "bf16"),
            ("pb_f32_matmul_stacked", 991, "pb_f32_matmul.cu",
             scan_fuse["launches"]["pb_f32_matmul_stacked"], "f32")):
        r = arm_row(name, row_groups=1, **({"arm": "cores"} if "f32" in name else
                                           {"arm": "dp4a"} if "int8" in name else {}))
        extra = {}
        if name == "pb_int8_matmul_stacked":  # the window rows, beside the flat kernel
            w = arm_row(name, m=ARM_MS[1], row_groups=1)
            extra = {"arm": r["arm"], "at_m{}".format(ARM_MS[1]): {
                "arm": w["arm"], "ms": w["kernel_ms"], "flat_ms": w["flat_ms"],
                "bound_ms": w["bound_ms"], "library_ms": w["library_ms"]}}
        if name == "pb_f32_matmul_stacked":
            extra = {"arm": "cores", "yardstick": True}
        kernels.append({**extra,
            "name": name, "route": "cuda", "source": f"pb_llm_tpu_torch/csrc/{source}",
            "replaces": f"pb_llm_tpu/ops/pallas_pb.py:{replaces}", "launches": launches,
            "max_abs_err": max(q["max_abs_err"] for q in arm_rows if q["kernel"] == name),
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "parity": "ok",
            "shape": "m={} ic={} oc={} low_frac 0.9; library: {} matmul on the dense weight; "
                     "launches: phase {}".format(*HEADLINE_SHAPE, library,
                                                 "9a" if name.endswith("f32_matmul_stacked")
                                                 else "9b")})
    ss = arm_row("pb_int8_matmul_stacked", row_groups=1, arm="split")
    kernels.append({
        "name": "pb_int8_matmul_stacked_split", "route": "cuda",
        "source": "pb_llm_tpu_torch/csrc/pb_int8_matmul.cu",
        "replaces": "pb_llm_tpu/ops/pallas_pb.py:953",
        "launches": e2e_launches("pb_int8_matmul_stacked", ("_split",)),
        "max_abs_err": max(q["max_abs_err"] for q in arm_rows
                           if q["kernel"] == "pb_int8_matmul_stacked" and q["arm"] == "split"),
        "ms": ss["kernel_ms"], "plain_ms": ss["plain_ms"], "bound_ms": ss["bound_ms"],
        "bound_by": ss["bound_by"], "library_ms": ss["library_ms"], "parity": "bit for bit",
        "arm": "split", "flat_ms": ss["flat_ms"],
        "dp4a_ms": arm_row("pb_int8_matmul_stacked", row_groups=1, arm="dp4a")["kernel_ms"],
        "shape": "m={} ic={} oc={} low_frac 0.9, layer 1 of 2; the split arm; library: bf16 "
                 "matmul on the dense weight; launches: phase 9b".format(*HEADLINE_SHAPE)})
    sf = arm_row("pb_f32_matmul_stacked", row_groups=1, arm="split")
    kernels.append({
        "name": "pb_f32_matmul_stacked_split", "route": "cuda",
        "source": "pb_llm_tpu_torch/csrc/pb_dma_v2.cu", "replaces": "pb_llm_tpu/ops/pallas_pb.py:991",
        "launches": scan_fuse["stacked_f32_split_launches"],
        "max_abs_err": max(q["max_abs_err"] for q in arm_rows
                           if q["kernel"] == "pb_f32_matmul_stacked" and q["arm"] == "split"),
        "ms": sf["kernel_ms"], "plain_ms": sf["plain_ms"], "bound_ms": sf["tensor_cores_bound_ms"],
        "bound_by": sf["tensor_cores_bound_by"], "library_ms": sf["library_ms"], "parity": "ok",
        "arm": "split", "flat_ms": sf["flat_ms"], "prep_ms": sf["prep_ms"],
        "cuda_cores_ms": arm_row("pb_f32_matmul_stacked", row_groups=1, arm="cores")["kernel_ms"],
        "shape": "m={} ic={} oc={} low_frac 0.9, layer 1 of 2; the dma kernel's split device code "
                 "(entry pb_dma_v2_split with a device layer index); library: f32 matmul on the "
                 "dense weight; launches: phase 9a".format(*HEADLINE_SHAPE)})
    st = arm_row("pb_f32_matmul_stacked", m=ARM_MS[1], row_groups=1, arm="tc")
    kernels.append({
        "name": "pb_f32_matmul_stacked_tc", "route": "cuda",
        "source": "pb_llm_tpu_torch/csrc/pb_bf16_tc.cuh", "replaces": "pb_llm_tpu/ops/pallas_pb.py:991",
        "launches": scan_fuse["stacked_f32_tc_launches"],
        "max_abs_err": max(q["max_abs_err"] for q in arm_rows
                           if q["kernel"] == "pb_f32_matmul_stacked" and q["arm"] == "tc"),
        "ms": st["kernel_ms"], "plain_ms": st["plain_ms"], "bound_ms": st["tensor_cores_bound_ms"],
        "bound_by": st["tensor_cores_bound_by"], "library_ms": st["library_ms"], "parity": "ok",
        "arm": "tc",
        "flat_ms": st["flat_ms"], "prep_ms": st["prep_ms"],
        "cuda_cores_ms": arm_row("pb_f32_matmul_stacked", m=ARM_MS[1], row_groups=1,
                                 arm="cores")["kernel_ms"],
        "shape": "m={} ic={} oc={} low_frac 0.9, layer 1 of 2; bf16 tensor cores, x in 3 terms "
                 "(entry pb_f32_matmul_stacked_tc in pb_f32_matmul.cu); library: f32 matmul on "
                 "the dense weight; launches: phase 9a".format(ARM_MS[1], *HEADLINE_SHAPE[1:])})
    http = {r["pass"]: r["launches"] for r in http_e2e}
    for (name, source, replaces, shape), (pass_name, _, _, counter), r in zip((
            ("decode_attention_q8", "decode_attention.cu", "decode_attention.py:78",
             "B={} S={} Hq={} Hkv={} D={} int8 strips, q8".format(*ATTN_SHAPE)),
            ("decode_attention_bf16", "decode_attention.cu", "decode_attention.py:78",
             "B={} S={} Hq={} Hkv={} D={} bf16 strips".format(*ATTN_SHAPE)),
            ("paged_attention_bf16", "paged_attention.cu", "paged_attention.py:35",
             "B=8 Hq=Hkv=32 D=128 bf16 pages of 16 (1025), decode")),
            KV_PASSES, (next(r for r in att_rows if r["arm"] == "q8"),
                        next(r for r in att_rows if r["arm"] == "bf16"),
                        next(r for r in pa_rows if r["case"] == "decode_bf16"))):
        if name.startswith("paged"):  # the CUDA-core arm (row 12b); its split arm next
            launches = http[pass_name]
            kernels += [{
                "name": name, "route": "cuda", "source": f"pb_llm_tpu_torch/csrc/{source}",
                "replaces": f"pb_llm_tpu/ops/{replaces}",
                "launches": launches["paged_attention_cuda_cores"], "yardstick": True,
                "max_abs_err": max(q["cuda_cores_max_abs_err"] for q in pa_rows
                                   if q["kv"] == "bf16"),
                "ms": r["cuda_cores_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["cuda_cores_bound_ms"], "bound_by": r["cuda_cores_bound_by"],
                "library_ms": r["library_ms"], "parity": "ok", "arm": "cuda_cores",
                "shape": shape + f", lengths <= {ATTN_MAX_LEN}; the CUDA-core arm; library: "
                                 "SDPA bf16; launches: phase 10b, that arm's over bf16 pages"}, {
                "name": name + "_split", "route": "cuda",
                "source": f"pb_llm_tpu_torch/csrc/{source}",
                "replaces": f"pb_llm_tpu/ops/{replaces}",
                "launches": launches["paged_attention_split"],
                "max_abs_err": max(q["split_max_abs_err"] for q in pa_rows
                                   if q["kv"] == "bf16" and "split_max_abs_err" in q),
                "ms": r["split_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["split_bound_ms"],
                "bound_by": r["split_bound_by"], "library_ms": r["library_ms"], "parity": "ok",
                "arm": "split", "cuda_cores_ms": r["cuda_cores_ms"],
                "shape": shape + f", lengths <= {ATTN_MAX_LEN}; the decode arm split; library: "
                                 "SDPA bf16; launches: phase 10b"}]
            continue
        kernels.append({
            "name": name, "route": "cuda", "source": f"pb_llm_tpu_torch/csrc/{source}",
            "replaces": f"pb_llm_tpu/ops/{replaces}", "launches": http[pass_name][counter],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "parity": "ok", "arm": "split", "slot_ms": r["slot_ms"],
            "shape": shape + f", lengths <= {ATTN_MAX_LEN}; library: SDPA bf16; "
                             "launches: phase 10b"})
    win = next(r for r in pa_rows if r["case"] == "chunk_t256_int8")
    prep = next(r for r in prep_rows if (r["m"], r["ic"], r["oc"]) == HEADLINE_SHAPE)
    kernels += [
        {"name": "paged_attention_window", "route": "cuda",
         "source": "pb_llm_tpu_torch/csrc/paged_attention.cu",
         "replaces": "pb_llm_tpu/ops/paged_attention.py:35",
         "launches": sum(r["launches"]["paged_attention_window"] for r in paged),
         "max_abs_err": max(r["tensor_cores_max_abs_err"] for r in pa_rows
                            if "tensor_cores_max_abs_err" in r),
         "ms": win["tensor_cores_ms"], "plain_ms": win["plain_ms"],
         "bound_ms": win["tensor_cores_bound_ms"], "bound_by": win["tensor_cores_bound_by"],
         "library_ms": win["library_ms"], "parity": "ok",
         "cuda_cores_ms": win["cuda_cores_ms"],
         "shape": "B=4 t=256 Hq=Hkv=32 D=128 int8 pages of 16 (1025), bases <= 1024, tensor "
                  "cores (2 bf16 terms); library: SDPA bf16; launches: phase 6b"},
        {"name": "pb_prep_int8", "route": "cuda", "source": "pb_llm_tpu_torch/csrc/pb_prep_int8.cu",
         "replaces": "pb_llm_tpu/ops/pallas_pb.py:478",
         "launches": e2e["prep_launches"] + sum(hf["matmul_launches_by_arm"].values())
         + hf_serve["prep_launches"],
         "max_abs_err": max(r["max_abs_err"] for r in prep_rows), "ms": prep["kernel_ms"],
         "plain_ms": prep["plain_ms"], "bound_ms": prep["bound_ms"], "bound_by": prep["bound_by"],
         "library_ms": None, "parity": "codes bit for bit, sums within sum_bound",
         "shape": "m={} ic={} oc={} (the x preparation XLA fuses into the int8 call); "
                  "launches: phases 4, 12a and 12b".format(*HEADLINE_SHAPE)},
    ]
    # a yardstick row is an arm kept to time the path's arm against (its own
    # launches, 0 where no layout of the path sends it there); every other row's
    # arm must have run on its path
    idle = [k["name"] for k in kernels if not k["launches"] and not k.get("yardstick")]
    if idle:
        raise AssertionError(f"kernels launched no time on the main paths: {idle}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
