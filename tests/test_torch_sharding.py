"""Port parity of the sharding rules (`pb_llm_tpu_torch.parallel.sharding`,
`parallel.collectives`' local views, `runtime.tp_engine`'s guards) against
the JAX package, in one process and without a process group: the port's
`param_specs` equals JAX's leaf for leaf (dense llama and OPT, PBW v1, PBW
v2 with global selection and with row groups, 2-bit v2, QAT leaves,
stacked layers, an indivisible vocab under `sanitize_specs`, fsdp over
dp = 2), each rank's `shard_params` block equals the shard JAX places on
that rank's device bit for bit, and each rank's local view of a packed
layer dequantizes to its block of the layer (the row-parallel PBW-v1 group
scales included).  JAX runs on the conftest's 8 host devices.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_tp import TP, families, llama_cfgs, llama_model, opt_model, pack_one, to_jax_layer
from pb_llm_tpu.models import stacking as jstacking
from pb_llm_tpu.parallel import collectives as jcoll, mesh as jmesh, sharding as jsharding
from pb_llm_tpu.quant.qat import QATLinear as JQATLinear
from pb_llm_tpu.train import qat as jqat
from pb_llm_tpu_torch.core.pbw import dequantize, dequantize_v2
from pb_llm_tpu_torch.models import stacking
from pb_llm_tpu_torch.parallel import collectives, sharding
from pb_llm_tpu_torch.parallel.mesh import Mesh, local_block
from pb_llm_tpu_torch.quant.qat import QATLinear
from pb_llm_tpu_torch.runtime.engine import EngineConfig
from pb_llm_tpu_torch.runtime.tp_engine import TPEngine

torch.set_num_threads(2)


def _qat_to_port(tree):
    """A JAX tree with QATLinear leaves in the port's types."""
    def conv(v):
        if isinstance(v, JQATLinear):
            return QATLinear(weight=torch.from_numpy(np.array(v.weight)),
                             bias=None if v.bias is None else torch.from_numpy(np.array(v.bias)),
                             outlier_mask=torch.from_numpy(np.array(v.outlier_mask)),
                             method=v.method, outlier_scale=v.outlier_scale,
                             train_outlier=v.train_outlier)
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, list):
            return [conv(x) for x in v]
        return None if v is None else torch.from_numpy(np.array(v))
    return conv(tree)


@pytest.fixture(scope="module")
def trees():
    """name → (family, JAX tree, port tree)."""
    out = {}
    j, _, t, _ = llama_model("dense")
    out["dense_llama"] = ("llama", j, t)
    j, _, t, _ = llama_model("dense", vocab=130)  # 130 % 4: lm_head replicates
    out["dense_llama_odd_vocab"] = ("llama", j, t)
    j, _, t, _ = opt_model("dense")
    out["dense_opt"] = ("opt", j, t)
    j, _, t, _ = llama_model("v1")
    out["v1"] = ("llama", j, t)
    j, _, t, _ = opt_model("v1", hidden=128, heads=8, groupsize=32)  # biases, group scales
    out["v1_opt_grouped"] = ("opt", j, t)
    j, _, t, _ = llama_model("v2", ic_shards=TP)
    out["v2"] = ("llama", j, t)
    j, _, t, _ = llama_model("v2", col_tile=32, ic_shards=TP)
    out["v2_row_groups"] = ("llama", j, t)
    j, _, t, _ = llama_model("v2", method="2bit")
    out["v2_2bit"] = ("llama", j, t)
    j = jstacking.stack_layers(out["v2"][1])
    out["v2_stacked"] = ("llama", j, stacking.stack_layers(out["v2"][2]))
    jd = llama_model("dense")[0]
    jq = jqat.replace_linears(jd, families("llama")[0], jqat.QATConfig())
    out["qat"] = ("llama", jq, _qat_to_port(jq))
    return out


def _same_spec(j, t, where=""):
    """JAX's spec ``j`` and the port's ``t``, entry for entry."""
    if isinstance(j, JP):
        assert isinstance(t, tuple) and tuple(j) == t, (where, j, t)
    elif j is None:
        assert t is None, (where, t)
    elif dataclasses.is_dataclass(j):
        assert type(j).__name__ == type(t).__name__, (where, j, t)
        for f in dataclasses.fields(j):
            _same_spec(getattr(j, f.name), getattr(t, f.name), f"{where}.{f.name}")
    elif isinstance(j, dict):
        assert set(j) == set(t), (where, set(j), set(t))
        for k in j:
            _same_spec(j[k], t[k], f"{where}/{k}")
    elif isinstance(j, (list, tuple)):
        assert len(j) == len(t), where
        for i, (a, b) in enumerate(zip(j, t)):
            _same_spec(a, b, f"{where}[{i}]")
    else:
        assert j == t, (where, j, t)


CASES = [("dense_llama", 1, False), ("dense_llama_odd_vocab", 1, False), ("dense_opt", 1, False),
         ("v1", 1, False), ("v1_opt_grouped", 1, False), ("v2", 1, False),
         ("v2_row_groups", 1, False), ("v2_2bit", 1, False), ("v2_stacked", 1, False),
         ("qat", 1, False), ("qat", 2, True), ("dense_llama", 2, True)]


@pytest.mark.parametrize("name,dp,fsdp", CASES)
def test_param_specs_equal_jax(trees, name, dp, fsdp):
    fam, jtree, ttree = trees[name]
    jm = jmesh.make_mesh(dp=dp, tp=TP)
    want = jsharding.param_specs(jtree, fam, jm, fsdp=fsdp)
    got = sharding.param_specs(ttree, fam, Mesh(dp, TP), fsdp=fsdp)
    _same_spec(want, got)


def test_specs_hold_the_layout_rules(trees):
    """What the cases above cover: global selection's side_idx replicated
    and row groups' sharded, 2-bit row-parallel v2 replicated, the odd
    vocab's lm_head replicated, fsdp's dp on the first free divisible dim."""
    m = Mesh(1, TP)
    spec = lambda n: sharding.param_specs(trees[n][2], trees[n][0], m)  # noqa: E731
    assert spec("v2")["layers"][0]["q_proj"].side_idx == ()
    assert spec("v2_row_groups")["layers"][0]["q_proj"].side_idx == (None, "tp")
    assert spec("v2_2bit")["layers"][0]["down_proj"].sign_packed == ()
    assert spec("v2_2bit")["layers"][0]["up_proj"].sign_packed == (None, "tp")
    assert spec("dense_llama")["lm_head"]["w"] == (None, "tp")
    assert spec("dense_llama_odd_vocab")["lm_head"]["w"] == ()
    assert spec("v2_stacked")["layers_stacked"]["o_proj"].sign_packed == (None, "tp", None)
    fs = sharding.param_specs(trees["qat"][2], "llama", Mesh(2, TP), fsdp=True)
    assert fs["layers"][0]["q_proj"].weight == ("tp", "dp")


def _bytes(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _leaves(j, t, where=""):
    """(path, JAX array, port tensor) of every tensor of the two trees."""
    if dataclasses.is_dataclass(j):
        for f in dataclasses.fields(j):
            yield from _leaves(getattr(j, f.name), getattr(t, f.name), f"{where}.{f.name}")
    elif isinstance(j, dict):
        for k in j:
            yield from _leaves(j[k], t[k], f"{where}/{k}")
    elif isinstance(j, (list, tuple)):
        for i, (a, b) in enumerate(zip(j, t)):
            yield from _leaves(a, b, f"{where}[{i}]")
    elif isinstance(j, jax.Array):
        yield where, j, t


# JAX's shard_params cannot place a 2-bit v2 tree (its spec keeps the
# dataclass's default low_bits, so the tree structures differ); the
# non-fsdp QAT case equals its fsdp case's tp blocks
@pytest.mark.parametrize("name,dp,fsdp", [c for c in CASES if c[0] != "v2_2bit"
                                          and (c[0] != "qat" or c[2])])
def test_shard_params_equal_jax_shards_bit_for_bit(trees, name, dp, fsdp):
    """Rank r's block of every tensor = the shard JAX's `shard_params`
    places on the mesh's r-th device."""
    fam, jtree, ttree = trees[name]
    jm = jmesh.make_mesh(dp=dp, tp=TP)
    jsh = jsharding.shard_params(jtree, jm, fam, fsdp=fsdp)
    devices = list(jm.devices.flat)
    for rank in range(dp * TP):
        local = sharding.shard_params(ttree, Mesh(dp, TP, rank=rank), fam, fsdp=fsdp)
        n = 0
        for where, arr, t in _leaves(jsh, local):
            shard = next(s for s in arr.addressable_shards if s.device == devices[rank])
            assert tuple(t.shape) == shard.data.shape, (where, rank)
            assert np.array_equal(_bytes(t.numpy()), _bytes(shard.data)), (where, rank)
            n += 1
        assert n > 0


@pytest.mark.parametrize("name,col", [("q_proj", True), ("o_proj", False), ("fc1", True),
                                      ("out_proj", False), ("fc2", False)])
def test_local_views_dequantize_to_their_blocks(trees, name, col):
    """Each rank's view of a packed layer (its block, local ic / oc /
    groupsize, its own group-scale rows) dequantizes to its block of the
    layer: v2 shard-major sidecars, v1 whole-row and grouped scales."""
    cases = [("v1", "llama"), ("v2", "llama")] if name in ("q_proj", "o_proj") else \
        [("v1_opt_grouped", "opt")]
    for tree, _ in cases:
        p = trees[tree][2]["layers"][1][name]
        deq = dequantize_v2 if tree.startswith("v2") else dequantize
        w = deq(p)
        for rank in range(TP):
            lp = collectives.local_linear(name, p, Mesh(1, TP, rank=rank))
            block = local_block(w, (None, "tp") if col else ("tp", None), Mesh(1, TP, rank=rank))
            assert (lp.ic, lp.oc) == tuple(block.shape), (tree, name)
            np.testing.assert_array_equal(deq(lp).numpy(), block.numpy(), err_msg=f"{tree} {rank}")


def test_row_parallel_pack_block_raise_is_jax_s():
    """A pack_block that does not divide ic/tp raises ValueError in both
    packages (JAX's `row_parallel_pb_matmul`, the port's before any
    collective), naming pack_block."""
    w = np.random.default_rng(5).standard_normal((256, 128)).astype(np.float32)
    p = pack_one(w, "xnor", "v1", seed=1, pack_block=128)  # ic/tp = 64
    with pytest.raises(ValueError, match="pack_block"):
        jcoll.row_parallel_pb_matmul(jax.numpy.zeros((2, 256)), to_jax_layer(p),
                                     jmesh.make_mesh(dp=1, tp=TP))
    with pytest.raises(ValueError, match="pack_block"):
        collectives.row_parallel_pb_matmul(torch.zeros(2, 256), p, Mesh(1, TP))


def test_tp_engine_guards(trees):
    """fuse_linears under TP raises NotImplementedError and tp not dividing
    the heads raises ValueError, as in JAX; a v2 row-parallel layer without
    a shard-major sidecar and a multi-bit one are refused before any
    collective."""
    _, cfg = llama_cfgs()
    ecfg = EngineConfig(n_slots=1, max_seq=32, prefill_buckets=(8,))
    fam = families("llama")[1]
    with pytest.raises(NotImplementedError, match="fuse_linears"):
        TPEngine(trees["v2"][2], cfg, fam, dataclasses.replace(ecfg, fuse_linears=True),
                 Mesh(1, TP), device="cpu")
    with pytest.raises(ValueError, match="must divide attention heads"):
        TPEngine(trees["v2"][2], cfg, fam, ecfg, Mesh(1, 3), device="cpu")
    with pytest.raises(ValueError, match="ic_shards=4"):
        TPEngine(llama_model("v2")[2], cfg, fam, ecfg, Mesh(1, TP), device="cpu")
    with pytest.raises(NotImplementedError, match="2-bit"):
        TPEngine(trees["v2_2bit"][2], cfg, fam, ecfg, Mesh(1, TP), device="cpu")



def test_make_caches_tp_holds_the_ranks_kv_heads():
    """`make_caches_tp`: a rank's strips are [slots, seq, kv_heads/tp,
    head_dim], the single-device strips under `kv_cache_spec`'s tp axis
    (int8 scales too)."""
    from pb_llm_tpu_torch.runtime import kv_cache
    from pb_llm_tpu_torch.runtime.tp_engine import make_caches_tp

    _, cfg = llama_cfgs(kv_heads=4)
    fam = families("llama")[1]
    full = kv_cache.make_caches(cfg, 2, 16, *kv_cache.cache_spec_for(cfg, "llama"), torch.int8,
                                "cpu")
    local = make_caches_tp(cfg, fam, Mesh(1, TP), 2, 16, torch.int8, "cpu")
    assert sharding.kv_cache_spec() == ("dp", None, "tp", None)
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in local] == [
        {k: tuple(local_block(v, (None, None, "tp"), Mesh(1, TP)).shape) for k, v in c.items()}
        for c in full]


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("model", ["llama", "opt"])
def test_tp_engine_takes_row_biases_out_once(model, scan):
    """The row-parallel linears' biases leave the tree at construction (the
    rank's partial sums carry none; the bias is added once after the
    all_reduce), so a step reuses each leaf's coefficient rows instead of
    rebuilding a bias-free copy: after a step every row-parallel leaf holds
    its rows, the same tensor after another step, and the greedy stream is
    the single-device engine's (a 1-rank gloo group, the int8 arms' plain
    versions, PBW v2: llama's linears without biases, OPT's with)."""
    import torch.distributed as dist

    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig
    from pb_llm_tpu_torch.parallel import mesh as pmesh
    from pb_llm_tpu_torch.runtime.engine import Engine

    _, _, tree, cfg = (opt_model if model == "opt" else llama_model)("v2")
    fam = families(model)[1]
    ecfg = EngineConfig(n_slots=1, max_seq=32, prefill_buckets=(8,), scan_layers=scan,
                        kernels=KernelConfig(backend="pallas_interpret", decode_dot="int8",
                                             prefill="int8"))
    prompt = [5, 17, 42, 3]
    ref = Engine(tree, cfg, fam, ecfg, device="cpu")
    want = [ref.prefill(0, prompt)] + [ref.decode_step()[0] for _ in range(3)]
    pmesh.multihost_initialize(pmesh.free_address(), 1, 0, device="cpu")
    try:
        eng = TPEngine(tree, cfg, fam, ecfg, pmesh.make_mesh(dp=1, tp=1), device="cpu")
        holders = [eng.params["layers_stacked"]] if scan else eng.params["layers"]
        rows = [lp[n] for lp in holders for n in lp if n in sharding.ROW_PARALLEL]
        assert rows and all(p.bias is None for p in rows)
        got = [eng.prefill(0, prompt), eng.decode_step()[0]]
        made = [p.coef_cache for p in rows]
        got += [eng.decode_step()[0] for _ in range(2)]
    finally:
        dist.destroy_process_group()
    assert all(c is not None for c in made)
    assert all(p.coef_cache is c for p, c in zip(rows, made))
    assert got == want
