"""The rank side of `tests/test_torch_ring_pp.py`: one world of 4 gloo ranks
runs every case of ring attention, `perplexity_sp`, the sequence-parallel
forward, `pipeline_forward` and `run_eval --sp 2`, over sp / pp meshes of
2 and 4 ranks (a mesh of 2 splits the world into two, which compute alike).
This module imports the port and torch only: the ranks import no JAX.
"""

from __future__ import annotations

import contextlib
import io

import torch


def _raises(fn) -> str:
    """The name of the exception ``fn`` raises ("" when none)."""
    try:
        fn()
    except Exception as e:  # the test compares the type's name with JAX's
        return type(e).__name__
    return ""


def run_all(rank: int, spec: dict) -> dict:
    torch.set_num_threads(1)
    from pb_llm_tpu_torch.eval.ppl import perplexity_sp
    from pb_llm_tpu_torch.models.attention import sequence_parallel
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.models.stacking import stack_layers
    from pb_llm_tpu_torch.parallel import mesh as pmesh
    from pb_llm_tpu_torch.parallel.pipeline import pipeline_forward
    from pb_llm_tpu_torch.parallel.ring_attention import (gather_rows, local_rows,
                                                          ring_attention_global)

    out: dict = {}
    meshes = {(a, n): (pmesh.make_sp_mesh(n) if a == "sp" else pmesh.make_pp_mesh(n))
              for a in ("sp", "pp") for n in (2, 4)}
    q, k, v = (torch.from_numpy(a) for a in spec["qkv"])
    for sp in (2, 4):
        for inner in ("xla", "flash_interpret"):
            out[("ring", sp, inner)] = ring_attention_global(
                q, k, v, spec["scale"], meshes["sp", sp], inner=inner).numpy()
    short = torch.zeros((1, 34, 2, 16))
    out["ring_indivisible"] = _raises(
        lambda: ring_attention_global(short, short, short, 0.25, meshes["sp", 4]))

    fam = family_for("llama")
    params, cfg = spec["ppl_params"], spec["ppl_cfg"]
    for sp in (2, 4):
        out[("ppl_sp", sp)] = perplexity_sp(params, cfg, fam.forward, spec["ppl_ids"],
                                            meshes["sp", sp], seqlen=spec["ppl_seqlen"])
    ids = torch.from_numpy(spec["gqa_ids"])
    mesh = meshes["sp", 4]
    with torch.inference_mode(), sequence_parallel(mesh):
        t_l = ids.shape[1] // 4
        logits, _ = fam.forward(spec["gqa_params"], local_rows(ids, mesh), spec["gqa_cfg"],
                                pos=mesh.coord("sp") * t_l)
        out["gqa_sp"] = gather_rows(logits, mesh).numpy()
        out["window_raises"] = _raises(lambda: fam.forward(
            spec["gqa_params"], local_rows(ids, mesh), spec["window_cfg"]))

    pp_ids = torch.from_numpy(spec["pp_ids"])
    for name, tree in spec["pp_trees"].items():
        stacked = stack_layers(tree)
        for pp, n_micro in ((4, 2), (2, 4)):
            out[("pp", name, pp)] = pipeline_forward(stacked, pp_ids, spec["pp_cfg"],
                                                     meshes["pp", pp], n_micro).numpy()
    two = stack_layers(spec["pp_two_layers"])
    out["pp_indivisible_layers"] = _raises(
        lambda: pipeline_forward(two, pp_ids, spec["pp_cfg"], meshes["pp", 4], 2))
    out["pp_unstacked"] = _raises(
        lambda: pipeline_forward(spec["pp_trees"]["dense"], pp_ids, spec["pp_cfg"],
                                 meshes["pp", 4], 2))
    out["pp_indivisible_batch"] = _raises(
        lambda: pipeline_forward(stack_layers(spec["pp_trees"]["dense"]), pp_ids,
                                 spec["pp_cfg"], meshes["pp", 2], 3))

    from pb_llm_tpu_torch.cli import run_eval

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_eval._eval_rank(rank, run_eval.build_parser().parse_args(spec["run_eval_argv"]),
                            "cpu")
    out["run_eval"] = buf.getvalue()
    return out
