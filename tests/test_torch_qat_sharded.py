"""Port parity of QAT across ranks (`train.qat` under a mesh,
`parallel.collectives`' autograd collectives, `quant.qat`'s sharded
statistics, `sharding.gather_params`) at dp = 2 × tp = 4 on gloo.

One module fixture spawns the eight rank processes once
(`parallel.mesh.run_ranks`; the ranks run
`tests/_torch_qat_sharded_worker.py`, which imports no JAX) and trains
every case there, while this process trains the same cases with JAX's
unsharded jitted `make_train_step` and with the port's one-process step.
The model is tests/test_sharding.py's tiny llama config (vocab 128, so the
lm_head is vocab-parallel; 8 heads, 2 layers, hidden 64), drawn by JAX's
`init_params`; one case is OPT (tied head, biases).  Two steps each (the
first update runs at lr 0, the second moves every weight), the CLI's
xnor_outlier method.

Bounds are tests/test_sharding.py's for JAX's own sharded step: the loss
within rtol 1e-5, the QAT weights (and biases) within atol 1e-5, rtol
1e-4; the masks bit for bit.  The order of sums differs from one device's
(row-parallel partial sums added by the all_reduce, the dp gradients
summed across ranks), hence not bit for bit.

The row statistics of xnor, irnet and bireal (each row's mean over ic, a
row split over tp) are held on one row-parallel layer, split over the tp
ranks, against JAX's layer and the port's whole one: the output within
tests/test_torch_qat.py's bounds (rtol 1e-5, atol 1e-5) and the weight
gradient within rtol 1e-4, atol 1e-4·max|g| (its bound for the layer's
gradient).  A whole model's training is no test of them: over 2 layers
and 2 steps even the port's one-process step moves xnor / irnet weights up
to 5.9e-4 from JAX's (Adam's step on near-cancelling row-centred
gradients), and bireal's first loss differs by 1e-5 (activation signs at
0), ROADMAP Queue 3.
"""

import concurrent.futures
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_qat_sharded_worker import DP, TP, row_parallel_linear, run_cases, snapshot, train_case
from pb_llm_tpu.models import llama as jllama
from pb_llm_tpu.models import opt as jopt
from pb_llm_tpu.models.registry import family_for as jfamily_for
from pb_llm_tpu.quant import qat as jq
from pb_llm_tpu.train import qat as jtq
from pb_llm_tpu_torch.interop import from_jax_params
from pb_llm_tpu_torch.models import llama as tllama
from pb_llm_tpu_torch.models import opt as topt
from pb_llm_tpu_torch.models.registry import FAMILIES
from pb_llm_tpu_torch.parallel.mesh import run_ranks
from pb_llm_tpu_torch.quant import qat as tq
from pb_llm_tpu_torch.train import qat as ttq

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
W_TOL = dict(atol=1e-5, rtol=1e-4)
STEPS = 2
LR = 1e-3

_LLAMA_FIELDS = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                 "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
                 "rms_norm_eps", "rope_theta", "sliding_window", "head_dim_override")
_OPT_FIELDS = ("vocab_size", "hidden_size", "ffn_dim", "num_hidden_layers", "num_attention_heads",
               "max_position_embeddings", "word_embed_proj_dim", "do_layer_norm_before",
               "layer_norm_eps")


def _llama():
    jcfg = jllama.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                              num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=8,
                              max_position_embeddings=64)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tllama.LlamaConfig(**{f: getattr(jcfg, f) for f in _LLAMA_FIELDS})


def _opt():
    jcfg = jopt.OPTConfig(vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                          num_attention_heads=4, max_position_embeddings=64)
    jp = jopt.init_params(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    for lp in jp["layers"]:  # nonzero biases, so that they train
        for n in jopt.LINEAR_NAMES:
            lp[n]["b"] = jnp.asarray(0.02 * rng.standard_normal(lp[n]["b"].shape), jnp.float32)
    return jcfg, jp, topt.OPTConfig(**{f: getattr(jcfg, f) for f in _OPT_FIELDS})


def _batches(seed, mask=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        b = {"input_ids": rng.integers(0, 128, size=(4, 16))}
        if mask is not None:
            b["attention_mask"] = mask.copy()
        out.append(b)
    return out


def _uneven_mask():
    """Pads fall unevenly on the dp shards: rows 0-1 (dp rank 0) keep 15 and
    13 positions, rows 2-3 (dp rank 1) 4 and 2."""
    m = np.zeros((4, 16), np.int64)
    for r, n in enumerate((15, 13, 4, 2)):
        m[r, :n] = 1
    return m


# name: (family, QATConfig kwargs, attention mask, fsdp); dp_tp and fsdp
# train the same batches, so one JAX run and one one-process run serve both
CASES = {
    "dp_tp": ("llama", dict(), None, False),
    "fsdp": ("llama", dict(), None, True),
    "uneven_pad": ("llama", dict(), _uneven_mask(), False),
    "grad_accum2": ("llama", dict(grad_accum=2), None, True),
    "opt": ("opt", dict(), None, False),
}
_SAME_AS = {"fsdp": "dp_tp"}
ROW_METHODS = ("xnor", "irnet", "bireal")


def _row_layer(method):
    """A row-parallel layer [oc 16, ic 64] (16 columns a tp rank), its
    input and the loss's upstream gradient, as numpy."""
    rng = np.random.default_rng(ROW_METHODS.index(method) + 7)
    w = (0.05 * rng.standard_normal((16, 64))).astype(np.float32)
    b = (0.02 * rng.standard_normal(16)).astype(np.float32)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    g = rng.standard_normal((4, 16)).astype(np.float32)
    return w, b, x, g


def _jax_train(jcfg, jp, family, qkw, batches):
    qcfg = jtq.QATConfig(**qkw)
    fam = jfamily_for(family)
    qp = jtq.replace_linears(copy.deepcopy(jp), fam, qcfg)
    opt = jtq.make_optimizer(qcfg, qp)
    step = jax.jit(jtq.make_train_step(jcfg, fam, qcfg, opt))
    state = opt.init(qp)
    losses = []
    for b in batches:
        qp, state, loss = step(qp, state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
    out = {}
    for i, lp in enumerate(qp["layers"]):
        for n in fam.linear_names:
            out[f"{i}/{n}/weight"] = np.asarray(lp[n].weight)
            out[f"{i}/{n}/mask"] = np.asarray(lp[n].outlier_mask)
            if lp[n].bias is not None:
                out[f"{i}/{n}/bias"] = np.asarray(lp[n].bias)
    return losses, out


@pytest.fixture(scope="module")
def runs():
    models = {"llama": _llama(), "opt": _opt()}
    cases, jax_cfgs = {}, {}
    for name, (family, qkw, mask, fsdp) in CASES.items():
        jcfg, jp, tcfg = models[family]
        qkw = dict(outlier_fraction=0.1, train_steps=4, learning_rate=LR, remat=True, **qkw)
        batches = _batches(list(CASES).index(_SAME_AS.get(name, name)), mask)
        cases[name] = {"family": family, "cfg": tcfg, "fsdp": fsdp, "qcfg": qkw,
                       "batches": batches,
                       "params": from_jax_params(jax.tree_util.tree_map(np.asarray, jp))}
        jax_cfgs[name] = (jcfg, jp, family, dict(qkw, remat=False), batches)
    layers, jax_layers = {}, {}
    for m in ROW_METHODS:
        w, b, x, g = _row_layer(m)
        layers[m] = (tq.make_qat_linear(torch.from_numpy(w), torch.from_numpy(b), 0.1, method=m),
                     torch.from_numpy(x), torch.from_numpy(g))
        q = jq.make_qat_linear(jnp.asarray(w), jnp.asarray(b), 0.1, method=m)
        y, vjp = jax.vjp(lambda wt: jq.apply_qat_linear(dataclasses.replace(q, weight=wt),
                                                         jnp.asarray(x)), q.weight)
        jax_layers[m] = (np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0]))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_ranks, run_cases, DP * TP, (cases, layers), "cpu")
        jax_runs = {n: _jax_train(*a) for n, a in jax_cfgs.items() if n not in _SAME_AS}
        jax_runs.update(jax_layers)
        one = {}
        for n, c in cases.items():
            if n in _SAME_AS:
                continue
            start = snapshot(ttq.replace_linears(copy.deepcopy(c["params"]),
                                                 FAMILIES[c["family"]], ttq.QATConfig(**c["qcfg"])))
            losses, params, sizes = train_case(c)
            one[n] = {"losses": losses, "tree": snapshot(params), "sizes": sizes, "start": start}
        one.update({m: row_parallel_linear(*layers[m]) for m in ROW_METHODS})
        for n, same in _SAME_AS.items():
            jax_runs[n], one[n] = jax_runs[same], one[same]
        return {"ranks": ranks.result(), "jax": jax_runs, "one": one}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_jax_and_one_process(runs, case):
    """Every rank's losses are rank 0's; the losses within rtol 1e-5 of
    JAX's unsharded step and of the port's one-process step; the gathered
    QAT weights and biases within atol 1e-5, rtol 1e-4 of both, the masks
    bit for bit; every weight moved."""
    got = runs["ranks"][0][case]
    for r in range(DP * TP):
        assert runs["ranks"][r][case]["losses"] == got["losses"]
    jl, jtree = runs["jax"][case]
    one = runs["one"][case]
    np.testing.assert_allclose(got["losses"], jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_RTOL)
    assert set(got["tree"]) == set(jtree) == set(one["tree"])
    for k, v in got["tree"].items():
        if k.endswith("/mask"):
            assert np.array_equal(v, jtree[k]) and np.array_equal(v, one["tree"][k]), k
            continue
        np.testing.assert_allclose(v, jtree[k], err_msg=k, **W_TOL)
        np.testing.assert_allclose(v, one["tree"][k], err_msg=k, **W_TOL)
        if k.endswith("/weight"):
            assert not np.array_equal(v, one["start"][k]), k


@pytest.mark.parametrize("case", [c for c, (_, _, _, fsdp) in CASES.items() if fsdp])
def test_fsdp_blocks_and_moments_are_an_eighth(runs, case):
    """Under fsdp each rank holds 1/(dp·tp) of every QAT weight, of its
    mask and of both Adam moments (ZeRO-3); without it, 1/tp."""
    whole = runs["one"][case]["sizes"]
    for r in range(DP * TP):
        for k, sizes in runs["ranks"][r][case]["sizes"].items():
            assert [s * DP * TP for s in sizes] == list(whole[k]), (r, k)
    for k, sizes in runs["ranks"][0]["dp_tp"]["sizes"].items():
        assert [s * TP for s in sizes] == list(runs["one"]["dp_tp"]["sizes"][k]), k


def test_uneven_pads_take_the_global_mean(runs):
    """The uneven-pad case's first loss is the global masked mean (JAX's),
    not the mean of the two dp shards' means, which lies far from it."""
    got = runs["ranks"][0]["uneven_pad"]["losses"][0]
    jl = runs["jax"]["uneven_pad"][0][0]
    np.testing.assert_allclose(got, jl, rtol=LOSS_RTOL)
    # the shards' means: every rank's first-step loss is the same global one
    assert all(runs["ranks"][r]["uneven_pad"]["losses"][0] == got for r in range(DP * TP))


@pytest.mark.parametrize("method", ROW_METHODS)
def test_row_statistics_on_a_row_parallel_shard(runs, method):
    """xnor / irnet / bireal on a layer whose rows split over the tp ranks:
    the row means and scales all-reduced (the centring mean with its
    gradient), the output and the weight gradient as JAX's whole layer and
    the port's; every rank the same."""
    y, grad = runs["ranks"][0][method]
    for r in range(DP * TP):
        assert np.array_equal(runs["ranks"][r][method][0], y)
        assert np.array_equal(runs["ranks"][r][method][1], grad)
    for ref_y, ref_g in (runs["jax"][method], runs["one"][method]):
        np.testing.assert_allclose(y, ref_y, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(grad, ref_g, rtol=1e-4, atol=1e-4 * np.abs(ref_g).max())
