#!/usr/bin/env python3
"""Design variants of the dma arm "split" and the planar arm "tc", timed in
one run on one NVIDIA card.

    python3 scripts/torch_tc_arm_variants.py     # from the repository root

At 8 rows of x (and 64 for the stage variants), on llama-7b's three shapes
(dma) and OPT-1.3B's three plus llama-7b's MLP (planar), random planes,
low_frac 0.9, it times with chip_smoke.py's `Timer` (CUDA events, L2
flushed):

  * the K split: each arm's K ranges a tile set to 1, 2, 4 and 8 in turn
    (`decode_arms.dma_ksplit`, `packed_matmul_v1.planar_ksplit` replaced
    for the run), beside the rule's own pick;
  * planar's stage, ring and column tile: copies of `csrc/pb_planar_v1.cu`
    with its sign words a stage (WPS, 2 or 4), its ring's bytes (RING,
    48–160 KB) or its output columns a block (OCT, 256: the code plane read
    in 256-byte runs, two 128-byte swizzled boxes side by side; at 8 rows
    only) changed, built with the port's nvcc flags beside the source and
    loaded with ctypes; each copy is first held against the plain version
    (rtol = atol = 1e-4).

Each line is one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KSPLITS = (1, 2, 4, 8)
# name: (WPS, RING in KB, OCT, rows timed)
PLANAR_VARIANTS = {"wps2_ring96": (2, 96, 128, (8, 64)), "wps4_ring96": (4, 96, 128, (8, 64)),
                   "wps2_ring48": (2, 48, 128, (8, 64)), "wps2_ring160": (2, 160, 128, (8, 64)),
                   "wps4_ring64": (4, 64, 128, (8, 64)), "wps4_ring160": (4, 160, 128, (8, 64)),
                   "oct256": (4, 96, 256, (8,))}
# the source's lines that a 256-column tile changes: the code rows of a word
# in two 128-byte boxes (halves), a thread's half and its column in it
OCT256_EDITS = (
    ("constexpr int OCT = 128;", "constexpr int OCT = 256;"),
    ("side_bytes = WPS * sr * 128;", "side_bytes = WPS * (OCT / 128) * sr * 128;"),
    ("      tma4(sb + C::side_at + wl * C::sr * 128, &msd, oc0, w - blk * g, 0, blk, bar);",
     "      for (int h = 0; h < OCT / 128; ++h)\n"
     "        tma4(sb + C::side_at + (wl * (OCT / 128) + h) * C::sr * 128, &msd, oc0 + 128 * h,\n"
     "             w - blk * g, 0, blk, bar);"),
    ("const uint8_t* sd = sb + C::side_at + wl * C::sr * 128;",
     "const uint8_t* sd = sb + C::side_at + (wl * (OCT / 128) + (wo >> 7)) * C::sr * 128;"),
    ("c = cl[cr];", "c = cl[cr] & 127;"),
)
PLANAR_SHAPES = ((2048, 2048, 128), (2048, 8192, 128), (8192, 2048, 128), (4096, 11008, -1))


def build_variants(build_dir: str) -> dict:
    """Copies of the planar source with WPS, RING and OCT changed, built at once."""
    from pb_llm_tpu_torch.ops import _build

    src = open(os.path.join(_build.CSRC, "pb_planar_v1.cu")).read()
    os.makedirs(build_dir, exist_ok=True)
    procs = {}
    for name, (wps, ring, oct_, _) in PLANAR_VARIANTS.items():
        edits = [("constexpr int WPS = 4;", f"constexpr int WPS = {wps};"),
                 ("constexpr int RING = 96 * 1024;", f"constexpr int RING = {ring} * 1024;")]
        text = src
        for old, new in edits + list(OCT256_EDITS if oct_ == 256 else ()):
            if text.count(old) != 1:
                raise RuntimeError(f"the {name} copy: {old!r} is not one line of the source")
            text = text.replace(old, new)
        path = os.path.join(build_dir, f"planar_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o",
             os.path.join(build_dir, f"lib_{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} copy:\n{log}")
        libs[name] = ctypes.CDLL(os.path.abspath(os.path.join(build_dir, f"lib_{name}.so")))
    return libs


def run_variant(lib, wps: int, x: torch.Tensor, p) -> torch.Tensor:
    """`launch_planar`'s arm "tc" through a variant library (stages of wps words)."""
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

    m, ic = x.shape
    oc = p.oc_local
    out = torch.empty((m, oc), device=x.device)
    stages = -(-ic // (32 * wps))
    xt = torch.empty((3, m, ic), dtype=torch.bfloat16, device=x.device)
    sums = torch.empty((stages, m), device=x.device)
    ks = v1.planar_ksplit(p)  # the rule's ranges, counted in its own stages
    fn = lib.pb_planar_v1_tc
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), xt.data_ptr(), sums.data_ptr(), p.sign_packed.data_ptr(),
             p.mask_packed.data_ptr(), p.sidecar.data_ptr(), v1.planar_coef(p).data_ptr(),
             out.data_ptr(), m, ic, oc, p.pack_block_local, p.low_bits, p.sidecar_bits,
             p.groupsize_local, p.n_groups, ks, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"pb_planar_v1_tc variant: cudaError {err}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tc_arm_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pb_llm_tpu_torch.data.synthetic import random_packed_v1, random_packed_v2
    from pb_llm_tpu_torch.ops import decode_arms as da
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

    card = cs.setup()
    timer = cs.Timer()
    gen = torch.Generator(device="cuda").manual_seed(3)
    rules = da.dma_ksplit, v1.planar_ksplit
    try:
        for ic, oc in cs.MATMUL_SHAPES:
            p = random_packed_v2(ic, oc, gen, low_frac=0.9)
            x = torch.randn((8, ic), generator=gen, device="cuda")
            ops = da.prepare_dma(x, p, "split")
            row = {"arm": "dma split", "m": 8, "ic": ic, "oc": oc, "rule_ks": rules[0](p),
                   "card": card}
            for ks in KSPLITS:
                da.dma_ksplit = lambda q, ks=ks: ks
                row[f"ks{ks}_ms"] = timer(lambda: da.launch_dma(ops, p))
            da.dma_ksplit = rules[0]
            print(json.dumps(row), flush=True)
        for ic, oc, gs in PLANAR_SHAPES:
            p = random_packed_v1(ic, oc, gen, low_frac=0.9, groupsize=gs)
            x = torch.randn((8, ic), generator=gen, device="cuda")
            row = {"arm": "planar tc", "m": 8, "ic": ic, "oc": oc, "groupsize": gs,
                   "rule_ks": rules[1](p), "card": card}
            for ks in KSPLITS:
                v1.planar_ksplit = lambda q, ks=ks: ks
                row[f"ks{ks}_ms"] = timer(lambda: v1.launch_planar(x, p, "tc"))
            v1.planar_ksplit = rules[1]
            print(json.dumps(row), flush=True)
    finally:
        da.dma_ksplit, v1.planar_ksplit = rules
    libs = build_variants(os.path.join(ROOT, "build", "variants"))
    for ic, oc, gs in PLANAR_SHAPES:
        p = random_packed_v1(ic, oc, gen, low_frac=0.9, groupsize=gs, bias=True)
        row = {"arm": "planar tc", "ic": ic, "oc": oc, "groupsize": gs, "card": card}
        for m in (8, 64):
            x = torch.randn((m, ic), generator=gen, device="cuda")
            want = v1.pb_planar_v1_plain(x, p)
            row[f"m{m}_rule_ms"] = timer(lambda: v1.launch_planar(x, p, "tc"))
            for name, lib in libs.items():
                wps, _, _, ms = PLANAR_VARIANTS[name]
                if m not in ms:
                    continue
                got = run_variant(lib, wps, x, p)
                torch.cuda.synchronize()
                if not torch.all((got - want).abs() <= 1e-4 + 1e-4 * want.abs()):
                    raise AssertionError(f"variant {name} m={m} {ic}x{oc}: beyond 1e-4")
                row[f"m{m}_{name}_ms"] = timer(lambda: run_variant(lib, wps, x, p))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
