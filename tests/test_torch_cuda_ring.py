"""Inference across ranks on the card: ring attention's flash inner and the
new collectives.

Every test carries the `cuda` marker and skips without a card; the file
imports no JAX, so it runs on the card's machine without the repository's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_ring.py

A 1-rank mesh holds the ring to one diagonal block, so the world of 2
gloo ranks sharing the card runs the ring itself (rank 1 holds a causal
and a full block): its flash inner (the kernel with its (m, l) residuals)
against its plain version ("flash_interpret") on the same blocks, at
flash's rtol = atol = 1e-4.  On a 1-rank NCCL group `broadcast_one_to_all`
and `ppermute` round trip as the identity (as JAX's `_broadcast` on one
process); NCCL with more ranks needs a card a rank.
"""

import numpy as np
import pytest
import torch

from pb_llm_tpu_torch.parallel import mesh as pmesh

FLASH_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _ring_rank(rank: int) -> dict:
    from pb_llm_tpu_torch.ops import flash_attention as fa
    from pb_llm_tpu_torch.parallel.ring_attention import local_rows, ring_attention

    mesh = pmesh.make_sp_mesh(2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (local_rows(torch.randn((2, 512, 4, 64), generator=gen, device="cuda"), mesh)
               for _ in range(3))
    out = {}
    for inner in ("flash", "flash_interpret"):
        before = (fa.residual_causal_launches, fa.residual_full_launches)
        with torch.inference_mode():
            out[inner] = ring_attention(q, k, v, 0.125, mesh, inner=inner).cpu().numpy()
        out[inner + "_launches"] = (fa.residual_causal_launches - before[0],
                                    fa.residual_full_launches - before[1])
    return out


@pytest.mark.cuda
def test_ring_flash_inner_matches_its_plain_version(cuda):
    ranks = pmesh.run_ranks(_ring_rank, 2, device="cuda", timeout=600)
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["flash"], r["flash_interpret"], rtol=FLASH_TOL,
                                   atol=FLASH_TOL)
        assert r["flash_launches"] == ((1, 0) if rank == 0 else (1, 1))
        assert r["flash_interpret_launches"] == (0, 0)


def _nccl_rank(rank: int) -> dict:
    import torch.distributed as dist

    from pb_llm_tpu_torch.parallel.collectives import broadcast_one_to_all, ppermute

    rec = np.arange(12, dtype=np.int32).reshape(3, 4)
    t = torch.arange(6, dtype=torch.float32, device="cuda")
    return {"backend": dist.get_backend(), "rec": broadcast_one_to_all(rec),
            "ring": ppermute(t).cpu().numpy()}


@pytest.mark.cuda
def test_nccl_broadcast_and_ppermute_round_trip(cuda):
    (r,) = pmesh.run_ranks(_nccl_rank, 1, device="cuda", timeout=300)
    assert r["backend"] == "nccl"
    np.testing.assert_array_equal(r["rec"], np.arange(12, dtype=np.int32).reshape(3, 4))
    np.testing.assert_array_equal(r["ring"], np.arange(6, dtype=np.float32))
