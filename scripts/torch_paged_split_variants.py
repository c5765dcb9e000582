#!/usr/bin/env python3
"""Design variants of paged decode attention's arm "split", and repeated
readings of both decode arms, timed in one run on one NVIDIA card.

    python3 scripts/torch_paged_split_variants.py     # from the repository root

On chip_smoke.py's decode cases of `PAGED_CASES` (t = 1: int8, f32 and bf16
pages, MHA and GQA; phase 2's pool, tables and NaN-filled unread pages,
`chip_smoke.paged_operands`) and EXTRA_CASES (int8 pages: lengths up to
2048, and phase 6b's first eight prompts 16 tokens in), with chip_smoke.py's
`Timer` (CUDA events, L2 flushed), it prints for each case:

  * ``readings``: the split arm and the CUDA-core arm through
    `paged_attention.launch`, READINGS times each in alternation, every
    reading a median of 20 calls; and the timer's floor, one empty kernel
    (`torch.cuda._sleep(1)`) timed the same way;
  * ``kernels``: device time a call by kernel (`torch.profiler`, 5 calls of
    each arm, the L2 flushed before each; the flush's own kernel left out);
  * ``variants``: the split arm's (keys a split, blocks a slot and kv head)
    in SHAPES through the built source and through copies of
    `csrc/paged_attention.cu`: "bulk" requests each chunk's rows as one
    cp.async.bulk copy a page segment onto an mbarrier (one thread), the
    lanes then reading shared memory; "steps8" gives a lane group 8 keys a
    chunk (128-key chunks: one max a 128-key split); "fused" merges in the
    kernel (FUSED_EDITS), with no second launch.  Each copy is built
    with the port's nvcc flags beside the source, loaded with ctypes, and
    first held against the plain version (chip_smoke.py's ATTN_RTOL,
    ATTN_ATOL).

Each line is one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

READINGS = 7
SHAPES = ((64, 4), (64, 8), (128, 2), (128, 4), (128, 8), (256, 4), (256, 8))
# the source's lines that the bulk copy changes: mbarrier helpers, the
# chunk's rows in dynamic shared memory, one thread's copies a page segment,
# the lanes' reads from shared memory, the launch's shared-memory size
BULK_EDITS = (
    ("// Splits c = blockIdx.x, + gridDim.x,",
     "__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,\n"
     "                                          uint64_t* bar) {\n"
     "  asm volatile(\n"
     "      \"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
     "[%3];\\n\"\n"
     "      ::\"r\"(smem_u32(dst)), \"l\"(src), \"r\"(bytes), \"r\"(smem_u32(bar)) : \"memory\");\n"
     "}\n\n"
     "__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {\n"
     "  asm volatile(\n"
     "      \"{\\n.reg .pred P1;\\nLAB_WAIT:\\n\"\n"
     "      \"mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\\n\"\n"
     "      \"@P1 bra DONE;\\nbra LAB_WAIT;\\nDONE:\\n}\\n\" ::\"r\"(smem_u32(bar)), "
     "\"r\"(parity) : \"memory\");\n"
     "}\n\n"
     "template <int BYTES>\n"
     "__device__ __forceinline__ void raw_s(const unsigned char* p, Raw<BYTES>& r) {\n"
     "  if constexpr (BYTES == 8) {\n"
     "    const uint2 v = *reinterpret_cast<const uint2*>(p);\n"
     "    r.w[0] = v.x;\n"
     "    r.w[1] = v.y;\n"
     "  } else {\n"
     "#pragma unroll\n"
     "    for (int i = 0; i < BYTES / 16; ++i) {\n"
     "      const uint4 v = reinterpret_cast<const uint4*>(p)[i];\n"
     "      r.w[4 * i] = v.x;\n"
     "      r.w[4 * i + 1] = v.y;\n"
     "      r.w[4 * i + 2] = v.z;\n"
     "      r.w[4 * i + 3] = v.w;\n"
     "    }\n"
     "  }\n"
     "}\n\n"
     "// Splits c = blockIdx.x, + gridDim.x,"),
    ("  __shared__ __align__(16) float sm_acc[GROUPS * SMAXD];\n",
     "  __shared__ __align__(16) float sm_acc[GROUPS * SMAXD];\n"
     "  extern __shared__ __align__(128) unsigned char rows_s[];  // a chunk's K rows, V rows\n"
     "  __shared__ __align__(8) uint64_t bar;\n"
     "  const int RB = D * (int)sizeof(T);  // bytes of a key row\n"
     "  if (threadIdx.x == 0) {\n"
     "    asm volatile(\"mbarrier.init.shared::cta.b64 [%0], 1;\\n\" ::\"r\"(smem_u32(&bar)));\n"
     "    asm volatile(\"fence.mbarrier_init.release.cluster;\\n\" ::: \"memory\");\n"
     "  }\n"
     "  __syncthreads();\n"
     "  int parity = 0;\n"),
    ("      Raw<LB> kr[STEPS], vr[STEPS];\n",
     "      if (threadIdx.x == 0) {  // a copy a page segment, live rows only\n"
     "        asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"
     "        asm volatile(\"mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n\"\n"
     "                     ::\"r\"(smem_u32(&bar)), \"r\"(2 * (kc_end - k0) * RB) : \"memory\");\n"
     "        for (int k = k0; k < kc_end;) {\n"
     "          const int pg = k / PS, off = k - pg * PS;\n"
     "          const int n = min(kc_end - k, PS - off);\n"
     "          const size_t row = ((size_t)__ldg(trow + pg) * Hkv + kvh) * PS + off;\n"
     "          bulk_copy(rows_s + (k - k0) * RB, kp + row * D, n * RB, &bar);\n"
     "          bulk_copy(rows_s + (CHUNK + k - k0) * RB, vp + row * D, n * RB, &bar);\n"
     "          k += n;\n"
     "        }\n"
     "      }\n"
     "      Raw<LB> kr[STEPS], vr[STEPS];\n"),
    ("        raw(kp + row * D + dl, kr[st]);\n        raw(vp + row * D + dl, vr[st]);\n", ""),
    ("\n      // the scores of the G heads; the chunk's max a head over the block\n",
     "      mbar_wait(&bar, parity);\n"
     "      parity ^= 1;\n"
     "#pragma unroll\n"
     "      for (int st = 0; st < STEPS; ++st) {\n"
     "        const int r = min(k0 + st * GROUPS + grp, kc_end - 1) - k0;\n"
     "        raw_s(rows_s + r * RB + dl * (int)sizeof(T), kr[st]);\n"
     "        raw_s(rows_s + (CHUNK + r) * RB + dl * (int)sizeof(T), vr[st]);\n"
     "      }\n"
     "\n      // the scores of the G heads; the chunk's max a head over the block\n"),
    ("  split_kernel<T, QUANT, MG><<<dim3(min(ns, grid_x), Hkv, B), GROUPS << lpr_log2, 0, st>>>(",
     "  const int smem = 2 * CHUNK * D * (int)sizeof(T);\n"
     "  {  // with the static shared memory, past 48 KB for f32 rows\n"
     "    const cudaError_t e = cudaFuncSetAttribute(\n"
     "        split_kernel<T, QUANT, MG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n"
     "    if (e != cudaSuccess) return (int)e;\n"
     "  }\n"
     "  split_kernel<T, QUANT, MG><<<dim3(min(ns, grid_x), Hkv, B), GROUPS << lpr_log2, smem, "
     "st>>>("),
)
STEPS8_EDITS = (("constexpr int STEPS = 4;", "constexpr int STEPS = 8;"),)
# the merge in the kernel: the last of a (slot, kv head)'s blocks to finish
# (a device counter a pair, reset by that block) adds the splits in split
# order, as the merge launch does; no second launch
FUSED_EDITS = (
    ("constexpr int SMAXD = 128;",
     "constexpr int SMAXD = 128;\n__device__ int arrive[1 << 16];  // a (slot, kv head)'s finished blocks"),
    ("             float* __restrict__ part, int t, int Hq,",
     "             float* __restrict__ part, float* __restrict__ out, int t, int Hq,"),
    ("  if ((int)blockIdx.x * sk >= len) return;\n",
     "  const int n_live = (len + sk - 1) / sk;  // the splits that hold keys\n"
     "  if ((int)blockIdx.x >= n_live) {\n"
     "    if (blockIdx.x == 0)  // a slot with no key: zeros\n"
     "      for (int i = threadIdx.x; i < R * D; i += blockDim.x)\n"
     "        out[(((size_t)b * t + i / D / G) * Hq + kvh * G + i / D % G) * D + i % D] = 0.f;\n"
     "    return;\n"
     "  }\n"),
    ("  }  // the splits\n}\n",
     "  }  // the splits\n\n"
     "  __shared__ int last;\n"
     "  __threadfence();  // this block's part rows, seen by the last block\n"
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0) {\n"
     "    int* cnt = arrive + (size_t)b * Hkv + kvh;\n"
     "    last = atomicAdd(cnt, 1) == min((int)gridDim.x, n_live) - 1;\n"
     "    if (last) *cnt = 0;  // ready for the next launch\n"
     "  }\n"
     "  __syncthreads();\n"
     "  if (!last) return;\n"
     "  __threadfence();\n"
     "  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {\n"
     "    const int r = i / D, d = i - r * D;\n"
     "    const size_t row = ((size_t)b * t + r / G) * Hq + kvh * G + r % G;\n"
     "    const float* p0 = part + row * ns * (D + 2);\n"
     "    float mx = NEG_INF;\n"
     "    for (int c = 0; c < n_live; ++c) mx = fmaxf(mx, __ldcg(p0 + (size_t)c * (D + 2) + D));\n"
     "    float lt = 0.f, a = 0.f;\n"
     "    for (int c = 0; c < n_live; ++c) {\n"
     "      const float* pc = p0 + (size_t)c * (D + 2);\n"
     "      const float w = expf(__ldcg(pc + D) - mx);\n"
     "      lt = fmaf(w, __ldcg(pc + D + 1), lt);\n"
     "      a = fmaf(w, __ldcg(pc + d), a);\n"
     "    }\n"
     "    out[row * D + d] = lt == 0.f ? 0.f : a / lt;\n"
     "  }\n"
     "}\n"),
    ("      q, (const T*)kp, (const T*)vp, ks, vs, table, base, part, t,",
     "      q, (const T*)kp, (const T*)vp, ks, vs, table, base, part, out, t,"),
    ("  const cudaError_t e = cudaGetLastError();\n"
     "  if (e != cudaSuccess) return (int)e;\n"
     "  merge_kernel<<<", "  return (int)cudaGetLastError();\n  merge_kernel<<<"),
)
COPIES = {"bulk": BULK_EDITS, "steps8": STEPS8_EDITS, "fused": FUSED_EDITS}
# beside PAGED_CASES' decode cases, int8 pages at MHA: lengths up to the
# table's 2048, and 6b's first eight prompts 16 tokens into their answers
# (two of 600-1000 tokens, two of 8-32, four of a 96-token prefix and 20-120)
EXTRA_CASES = (("decode_int8_long", 8, 1, 32, 32, 128, "int8", 2047, None),
               ("decode_int8_6b", 8, 1, 32, 32, 128, "int8", None, "6b"))


def build_copies(build_dir: str) -> dict:
    """The COPIES of the paged source, built at once; {name: ctypes library}."""
    from pb_llm_tpu_torch.ops import _build

    src = open(os.path.join(_build.CSRC, "paged_attention.cu")).read()
    os.makedirs(build_dir, exist_ok=True)
    procs = {}
    for name, edits in COPIES.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"the {name} copy: {old!r} is not once in the source")
            text = text.replace(old, new)
        path = os.path.join(build_dir, f"paged_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o",
             os.path.join(build_dir, f"lib_paged_{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} copy:\n{out}")
        libs[name] = ctypes.CDLL(os.path.abspath(os.path.join(build_dir, f"lib_paged_{name}.so")))
    return libs


def run_split(lib, qs, k, v, table, base, ks, vs, keys: int, grid: int) -> torch.Tensor:
    """`paged_attention.launch`'s arm "split" through ``lib``, with ``keys``
    keys a split (whole pages) and ``grid`` blocks a slot and kv head."""
    from pb_llm_tpu_torch.ops import paged_attention as tpa

    b, t, hq, d = qs.shape
    hkv, ps, maxp = k.shape[1], k.shape[2], table.shape[1]
    sk = ps * max(1, keys // ps)
    out = torch.empty((b, t, hq, d), dtype=torch.float32, device=qs.device)
    part = torch.empty((b, t, hq, -(-maxp * ps // sk), d + 2), dtype=torch.float32,
                       device=qs.device)
    fn = lib.paged_attention_split
    fn.argtypes = tpa._SPLIT_ARGTYPES
    fn.restype = ctypes.c_int
    quantized = ks is not None
    err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr() if quantized else None,
             vs.data_ptr() if quantized else None, table.data_ptr(), base.data_ptr(),
             out.data_ptr(), part.data_ptr(), b, t, hq, hkv, d, ps, maxp,
             tpa.KV_TYPES[k.dtype], sk, grid, torch.cuda.current_stream(qs.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention_split variant: cudaError {err}")
    return out


def by_kernel(timer, fns: dict, calls: int = 5) -> dict:
    """Device ms a call by kernel name for each callable (`torch.profiler`),
    the L2 flushed before each call; the flush's kernel is left out."""
    from torch.profiler import ProfilerActivity, profile

    got = {}
    for arm, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                timer.flush_buf.zero_()
                torch.cuda._sleep(200_000)
                fn()
            torch.cuda.synchronize()
        names = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                names[ev.name] = names.get(ev.name, 0.0) + ev.time_range.elapsed_us()
        got[arm] = {n[:60]: us / calls / 1e3 for n, us in names.items()
                    if "sleep" not in n.lower() and "fill" not in n.lower()
                    and "zero" not in n.lower()} or "not measured"
    return got


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_paged_split_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pb_llm_tpu_torch.ops import _build
    from pb_llm_tpu_torch.ops import paged_attention as tpa

    card = cs.setup()
    timer = cs.Timer()
    libs = {"vector": _build.load("paged_attention"),
            **build_copies(os.path.join(ROOT, "build", "variants"))}
    gen = torch.Generator(device="cuda").manual_seed(12)
    rng = np.random.default_rng(13)
    ps = cs.PAGED_POOL[1]
    cases = [c + (None,) for c in cs.PAGED_CASES if c[2] == 1] + list(EXTRA_CASES)
    for name, b, t, hq, hkv, d, kind, max_base, bases in cases:
        if bases == "6b":  # each prompt's length, 16 tokens in (base: the last key's index)
            bases = [len(p) + 15 for p in cs.paged_prompts(cs.llama7b(1).vocab_size)[:b]]
        q, k, v, ks, vs, table, base = cs.paged_operands(b, t, hq, hkv, d, kind, max_base, gen,
                                                         rng, bases)
        scale = d ** -0.5
        want = tpa.paged_attention_plain(q, k, v, table, base, scale, ps, ks, vs)
        qs, bs = (q * scale).contiguous(), base.to(torch.int32)

        def arm(a):
            return lambda: tpa.launch(qs, k, v, table, bs, ks, vs, decode=True, _arm_for_timing=a)

        reads = {tpa.SPLIT: [], tpa.CUDA_CORES: [], "floor": []}
        for _ in range(READINGS):
            for a in (tpa.SPLIT, tpa.CUDA_CORES):
                reads[a].append(timer(arm(a)))
            reads["floor"].append(timer(lambda: torch.cuda._sleep(1)))
        print(json.dumps({
            "case": name, "kv": kind, "Hq": hq, "Hkv": hkv, "bases": base.tolist(),
            "readings_ms": reads,
            "median_ms": {a: statistics.median(r) for a, r in reads.items()},
            "range_ms": {a: [min(r), max(r)] for a, r in reads.items()},
            "split_faster_in": sum(s < c for s, c in zip(reads[tpa.SPLIT], reads[tpa.CUDA_CORES])),
            "readings": READINGS, "SPLIT_KEYS": tpa.SPLIT_KEYS, "SPLIT_GRID": tpa.SPLIT_GRID,
            "card": card}), flush=True)
        print(json.dumps({"case": name, "kernels_ms": by_kernel(
            timer, {tpa.SPLIT: arm(tpa.SPLIT), tpa.CUDA_CORES: arm(tpa.CUDA_CORES)}),
            "card": card}), flush=True)
        var, two_launch = {}, {}
        for lib_name, lib in libs.items():
            for keys, grid in SHAPES:
                got = run_split(lib, qs, k, v, table, bs, ks, vs, keys, grid)
                torch.cuda.synchronize()
                e = (got - want).abs()
                if not (torch.isfinite(got).all()
                        and torch.all(e <= cs.ATTN_ATOL + cs.ATTN_RTOL * want.abs())):
                    raise AssertionError(f"{name} {lib_name} {keys}x{grid}: max|err| "
                                         f"{e.max().item()}")
                if lib_name == "vector":
                    two_launch[keys, grid] = got
                elif lib_name == "fused" and not torch.equal(got, two_launch[keys, grid]):
                    raise AssertionError(f"{name} fused {keys}x{grid}: not the merge launch's bits")
                var[f"{lib_name}_{keys}x{grid}"] = timer(
                    lambda: run_split(lib, qs, k, v, table, bs, ks, vs, keys, grid))
        print(json.dumps({"case": name, "variants_ms": var, "card": card}), flush=True)
        del q, k, v, ks, vs, table, base, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
