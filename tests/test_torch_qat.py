"""Port parity for QAT (`pb_llm_tpu_torch.quant.{ste,qat}`, `train.qat`,
`utils.params`, `data.loaders.get_qat_dataset`) against the JAX package on
the CPU.

Bounds, each derived where it is checked:
  * bit for bit: `weight_quant_8bit` (both modes, negative codes included),
    `gen_outlier_mask`, the hessian variant's mask inversion, `ste_sign`'s
    gradient, the frozen tensors after training, `get_qat_dataset`'s
    batches;
  * irnet / fda gradients within 2 ulps (rtol 2.5e-7): tanh and cos are
    XLA's own approximations against libm's;
  * the binary scale within 4 ulps: JAX sums in XLA's f32 tree order, the
    port in f64 (the same on every device);
  * training, 4 steps at lr 5e-3 on 2 layers of hidden 64: per-step losses
    within 1e-5 (~2e-6 of the loss), QAT weights within 1e-5 (0.2% of one
    lr step), the lr as optax's schedule within 1e-6 relative and 4 f32
    ulps of the peak (optax in f32, the port in Python floats) and exactly 0
    at the first update.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pb_llm_tpu.core.packing import csr_sidecar_bits as jcsr_sidecar_bits
from pb_llm_tpu.data.loaders import get_qat_dataset as jget_qat_dataset
from pb_llm_tpu.data.synthetic import ByteTokenizer as JByteTokenizer
from pb_llm_tpu.data.synthetic import synthetic_source as jsynthetic_source
from pb_llm_tpu.models import llama as jllama
from pb_llm_tpu.models import opt as jopt
from pb_llm_tpu.models.registry import family_for as jfamily_for
from pb_llm_tpu.quant import qat as jq
from pb_llm_tpu.quant import ste as jste
from pb_llm_tpu.train import qat as jtq
from pb_llm_tpu.utils import params as jparams_util
from pb_llm_tpu_torch.core.packing import csr_sidecar_bits
from pb_llm_tpu_torch.data.loaders import get_qat_dataset
from pb_llm_tpu_torch.data.synthetic import ByteTokenizer, synthetic_source
from pb_llm_tpu_torch.interop import from_jax_params
from pb_llm_tpu_torch.models import llama as tllama
from pb_llm_tpu_torch.models import opt as topt
from pb_llm_tpu_torch.models.registry import family_for
from pb_llm_tpu_torch.ops import flash_attention as tfa
from pb_llm_tpu_torch.quant import qat as tq
from pb_llm_tpu_torch.quant import ste as tste
from pb_llm_tpu_torch.train import qat as ttq
from pb_llm_tpu_torch.utils import params as tparams_util

torch.set_num_threads(2)

LR = 5e-3
STEPS = 4
LOSS_ATOL = 1e-5
PARAM_ATOL = 1e-5
LR_RTOL = 1e-6
LR_ATOL = 4 * 2.0 ** -23  # of the peak lr: optax's f32 1 + cos cancels at the decay's end


def _w(oc=8, ic=64, seed=0, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((oc, ic)) * scale + shift).astype(np.float32)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


# ---------------------------------------------------------------------------
# STE functions
# ---------------------------------------------------------------------------

STE = {"ste_sign": (jste.ste_sign, tste.ste_sign, 0.0),
       "irnet_sign": (jste.irnet_sign, tste.irnet_sign, 2.5e-7),
       "fda_sign": (jste.fda_sign, tste.fda_sign, 2.5e-7)}


@pytest.mark.parametrize("name", sorted(STE))
def test_ste_gradients_match_custom_vjp(name):
    jf, tf, rtol = STE[name]
    x = np.concatenate([np.linspace(-2, 2, 401), [0.0, -0.0, 1.0, -1.0]]).astype(np.float32)
    g = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    jy, jvjp = jax.vjp(jf, jnp.asarray(x))
    (jg,) = jvjp(jnp.asarray(g))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    ty = tf(xt)
    ty.backward(torch.from_numpy(g))
    # sign, sign(±0) == 0 (jnp.sign(-0.0) is -0.0, torch.sign(-0.0) +0.0)
    assert np.array_equal(ty.detach().numpy(), np.asarray(jy))
    if rtol == 0.0:
        assert np.array_equal(_bits(xt.grad), _bits(jg))
    else:
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=rtol, atol=1e-30)
    if name == "fda_sign":  # zeroed outside [-1, 1]
        assert (xt.grad.numpy()[np.abs(x) > 1] == 0).all()


def test_ste_round_clamp_identity_gradient():
    x = np.linspace(-5, 5, 41).astype(np.float32)
    g = np.arange(41, dtype=np.float32)
    jy, jvjp = jax.vjp(lambda v: jste.ste_round_clamp(v, -3.0, 3.0), jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    ty = tste.ste_round_clamp(xt, -3.0, 3.0)
    ty.backward(torch.from_numpy(g))
    assert np.array_equal(_bits(ty.detach()), _bits(jy))
    assert np.array_equal(_bits(xt.grad), _bits(jvjp(jnp.asarray(g))[0]))


# ---------------------------------------------------------------------------
# QAT layers
# ---------------------------------------------------------------------------

# (oc, ic, scale, shift): LLM-like rows (zp 0, the wrap fires on every
# negative weight), rows with min < -0.5 (zp -1, -2), all-negative rows
Q8_CASES = [(64, 96, 0.02, 0.0), (32, 128, 1.0, 0.3), (16, 40, 3.0, -1.2), (8, 64, 0.02, -0.01)]


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("case", range(len(Q8_CASES)))
def test_weight_quant_8bit_bit_identical(case, wrap):
    oc, ic, scale, shift = Q8_CASES[case]
    w = _w(oc, ic, seed=case, scale=scale, shift=shift)
    want = jq.weight_quant_8bit(jnp.asarray(w), wrap)
    got = tq.weight_quant_8bit(torch.from_numpy(w), wrap)
    assert np.array_equal(_bits(got), _bits(want))
    if wrap and shift <= 0.0:  # the wrap fired: some codes were negative
        zp = np.round(w.min(-1, keepdims=True))
        assert ((w - zp) < 0).any()


@pytest.mark.parametrize("frac", [0.02, 0.1, 0.3])
def test_outlier_mask_bit_identical(frac):
    w = _w(48, 96, seed=7)
    want = np.asarray(jq.gen_outlier_mask(jnp.asarray(w), frac))
    got = tq.gen_outlier_mask(torch.from_numpy(w), frac).numpy()
    assert np.array_equal(got, want)


def test_hessian_variant_inverts_gptq_mask():
    w = _w(seed=4)
    gmask = np.random.default_rng(4).random(w.shape) < 0.6  # binarized
    want = jq.make_qat_linear(jnp.asarray(w), None, 0.5, method="xnor_outlier_hessian",
                              gptq_mask=gmask)
    got = tq.make_qat_linear(torch.from_numpy(w), None, 0.5, method="xnor_outlier_hessian",
                             gptq_mask=gmask)
    assert np.array_equal(got.outlier_mask.numpy(), np.asarray(want.outlier_mask))
    assert np.array_equal(got.outlier_mask.numpy(), ~gmask)
    assert np.array_equal(_bits(got.weight.detach()), _bits(want.weight))
    assert got.weight.requires_grad and got.weight.is_leaf


def test_binary_scale_within_ulps():
    for seed in range(4):
        w = _w(32, 128, seed=seed, scale=0.02 * (seed + 1))
        want = np.float32(jq.binary_scale_of(jq.make_qat_linear(jnp.asarray(w), None, 0.1)))
        got = np.float32(tq.binary_scale_of(tq.make_qat_linear(torch.from_numpy(w), None, 0.1)))
        assert abs(int(_bits(got).item()) - int(_bits(want).item())) <= 4


def _pair_linear(method, seed=3, bias=True):
    w = _w(16, 64, seed=seed, scale=0.5)
    b = _w(1, 16, seed=seed + 1)[0] if bias else None
    j = jq.make_qat_linear(jnp.asarray(w), None if b is None else jnp.asarray(b), 0.1,
                           method=method)
    t = tq.make_qat_linear(torch.from_numpy(w), None if b is None else torch.from_numpy(b), 0.1,
                           method=method)
    return j, t


@pytest.mark.parametrize("method", jq.QAT_METHODS)
def test_quant_weight_and_linear_match(method):
    """The fake-quant weight within 4 ulps of the binary scale (xnor_outlier)
    or the row means' order (xnor, irnet, bireal: ±scale values, 1e-6); the
    linear's output and its input gradient within f32 matmul rounding."""
    assert tq.QAT_METHODS == jq.QAT_METHODS
    j, t = _pair_linear(method)
    want = np.asarray(jq.quant_weight(j))
    got = tq.quant_weight(t).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    x = np.random.default_rng(9).standard_normal((5, 64)).astype(np.float32)
    jy, jvjp = jax.vjp(lambda v: jq.apply_qat_linear(j, v), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    ty = tq.apply_qat_linear(t, xt)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    gy = np.ones_like(np.asarray(jy))
    ty.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jvjp(jnp.asarray(gy))[0]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["xnor_outlier", "xnor", "irnet", "fda", "bireal"])
def test_weight_gradient_matches_jax(method):
    """d loss / d weight through the STE: only binary positions get
    gradient for xnor_outlier (the outliers are detached)."""
    j, t = _pair_linear(method, seed=5, bias=False)
    x = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)

    def jloss(weight):
        lin = jq.QATLinear(weight=weight, bias=None, outlier_mask=j.outlier_mask, method=method)
        return jnp.sum(jq.apply_qat_linear(lin, jnp.asarray(x)) ** 2)

    want = np.asarray(jax.grad(jloss)(j.weight))
    torch.sum(tq.apply_qat_linear(t, torch.from_numpy(x)) ** 2).backward()
    got = t.weight.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    if method == "xnor_outlier":
        mask = t.outlier_mask.numpy()
        assert np.abs(got[mask]).max() == 0.0
        assert np.abs(got[~mask]).max() > 0.0


def test_bireal_activation_gradient():
    x = np.linspace(-2, 2, 9).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jq.bireal_activation(v)))(jnp.asarray(x)))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    y = tq.bireal_activation(xt)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.sign(x))
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    assert xt.grad[0] == 0.0 and xt.grad[-1] == 0.0 and xt.grad[4] == 2.0


@pytest.mark.parametrize("frac", [0.05, 0.1, 0.3])
def test_mean_effective_bits_and_csr(frac):
    w = _w(64, 64, seed=6)
    j = jq.make_qat_linear(jnp.asarray(w), None, frac)
    t = tq.make_qat_linear(torch.from_numpy(w), None, frac)
    assert tq.mean_effective_bits(t) == jq.mean_effective_bits(j)
    mask = t.outlier_mask.numpy()
    assert csr_sidecar_bits(mask) == jcsr_sidecar_bits(mask)
    assert csr_sidecar_bits(mask, 4, 16) == jcsr_sidecar_bits(mask, 4, 16)


def test_param_reports_match():
    w = _w()
    jlin = jq.make_qat_linear(jnp.asarray(w), jnp.zeros(8), 0.1)
    tlin = tq.make_qat_linear(torch.from_numpy(w), torch.zeros(8), 0.1)
    jtree = {"layers": [{"q": jlin, "fc1": {"w": jnp.ones((4, 4)), "b": None},
                         "fc2": {"w": jnp.zeros((4, 4)), "b": None},
                         "fc3": {"w": jnp.zeros((2, 2)), "b": None}}], "norm": jnp.ones(3)}
    ttree = {"layers": [{"q": tlin, "fc1": {"w": torch.ones(4, 4), "b": None},
                         "fc2": {"w": torch.zeros(4, 4), "b": None},
                         "fc3": {"w": torch.zeros(2, 2), "b": None}}], "norm": torch.ones(3)}
    assert tparams_util.count_parameters(ttree) == jparams_util.count_parameters(jtree)
    assert tparams_util.zero_fraction_report(ttree) == jparams_util.zero_fraction_report(jtree)
    assert tparams_util.print_trainable_parameters(ttree) == \
        jparams_util.print_trainable_parameters(jtree)
    report = tparams_util.device_memory_report()
    assert report and all(isinstance(v, float) for v in report.values())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

_LLAMA_FIELDS = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                 "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
                 "rms_norm_eps", "rope_theta", "sliding_window", "head_dim_override")
_OPT_FIELDS = ("vocab_size", "hidden_size", "ffn_dim", "num_hidden_layers", "num_attention_heads",
               "max_position_embeddings", "word_embed_proj_dim", "do_layer_norm_before",
               "layer_norm_eps")


def _models(family):
    if family == "llama":
        jcfg = jllama.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                                  num_hidden_layers=2, num_attention_heads=4,
                                  num_key_value_heads=2, max_position_embeddings=64)
        jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
        tcfg = tllama.LlamaConfig(**{f: getattr(jcfg, f) for f in _LLAMA_FIELDS})
    else:
        jcfg = jopt.OPTConfig(vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                              num_attention_heads=4, max_position_embeddings=64)
        jp = jopt.init_params(jcfg, jax.random.PRNGKey(1))
        rng = np.random.default_rng(1)
        for lp in jp["layers"]:  # nonzero biases, so that they train and count
            for n in jopt.LINEAR_NAMES:
                lp[n]["b"] = jnp.asarray(0.02 * rng.standard_normal(lp[n]["b"].shape),
                                         jnp.float32)
        tcfg = topt.OPTConfig(**{f: getattr(jcfg, f) for f in _OPT_FIELDS})
    return jcfg, jp, tcfg, from_jax_params(jax.tree_util.tree_map(np.asarray, jp))


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 128, size=(4, 24)),
             "attention_mask": (rng.random((4, 24)) > 0.2).astype(np.int64)}
            for _ in range(STEPS)]


def _snapshot(tree):
    return copy.deepcopy(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module", params=[("llama", 1), ("opt", 1), ("llama", 2)],
                ids=["llama", "opt", "llama-grad_accum2"])
def trained(request):
    family, ga = request.param
    jcfg, jp, tcfg, tp = _models(family)
    qkw = dict(outlier_fraction=0.1, train_steps=STEPS, learning_rate=LR, remat=True,
               grad_accum=ga)
    data = _batches()
    jqp = jtq.replace_linears(jp, jfamily_for(family), jtq.QATConfig(**qkw))
    jq0 = _snapshot(jqp)
    jqp, jl = jtq.train(jqp, jcfg, jfamily_for(family), jtq.QATConfig(**qkw), iter(data))
    base = {k: copy.deepcopy(v) for k, v in tp.items()}
    tqp = ttq.replace_linears(tp, family_for(family), ttq.QATConfig(**qkw))
    tq0 = {lp_i: {n: (lin.weight.detach().clone(), lin.outlier_mask.clone())
                  for n, lin in lp.items() if isinstance(lin, tq.QATLinear)}
           for lp_i, lp in enumerate(tqp["layers"])}
    tqp, tl = ttq.train(tqp, tcfg, family_for(family), ttq.QATConfig(**qkw), iter(data))
    return dict(family=family, jcfg=jcfg, tcfg=tcfg, jq0=jq0, jqp=jqp, jl=jl, tqp=tqp, tl=tl,
                tq0=tq0, base=base)


def test_training_losses_match(trained):
    np.testing.assert_allclose(trained["tl"], trained["jl"], rtol=0, atol=LOSS_ATOL)


def test_training_masks_and_masters_bit_identical(trained):
    fam = family_for(trained["family"])
    for i, lp in enumerate(trained["jq0"]["layers"]):
        for n in fam.linear_names:
            w0, m0 = trained["tq0"][i][n]
            assert np.array_equal(m0.numpy(), np.asarray(lp[n].outlier_mask))
            assert np.array_equal(_bits(w0), _bits(lp[n].weight))


def test_training_params_match(trained):
    fam = family_for(trained["family"])
    for i, lp in enumerate(trained["jqp"]["layers"]):
        for n in fam.linear_names:
            t = trained["tqp"]["layers"][i][n]
            np.testing.assert_allclose(t.weight.detach().numpy(), np.asarray(lp[n].weight),
                                       rtol=0, atol=PARAM_ATOL)
            if t.bias is not None:
                np.testing.assert_allclose(t.bias.detach().numpy(), np.asarray(lp[n].bias),
                                           rtol=0, atol=PARAM_ATOL)
            # every QAT weight moved (the first update is at lr 0, three are not)
            assert not torch.equal(t.weight.detach(), trained["tq0"][i][n][0])


def test_training_frozen_tensors_unchanged(trained):
    """Every tensor outside the QAT linears is bit-unchanged and frozen."""

    def walk(a, b, where):
        if isinstance(a, tq.QATLinear):
            return
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{where}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{where}/{i}")
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b) and not a.requires_grad, where

    walk(trained["tqp"], trained["base"], "")


def test_export_dense_matches_qat_forward(trained):
    """export_dense's forward = the QAT forward (JAX's test bound), and both
    = JAX's QAT forward within f32 rounding."""
    fam, cfg = family_for(trained["family"]), trained["tcfg"]
    ids = np.random.default_rng(1).integers(0, 128, size=(2, 16))
    with torch.no_grad():
        logits_qat, _ = fam.forward(trained["tqp"], torch.from_numpy(ids), cfg,
                                    linear_fn=ttq.qat_linear_fn)
        logits_dense, _ = fam.forward(ttq.export_dense(trained["tqp"], fam), torch.from_numpy(ids),
                                      cfg)
    np.testing.assert_allclose(logits_dense.numpy(), logits_qat.numpy(), rtol=1e-4, atol=1e-5)
    jlogits, _ = jfamily_for(trained["family"]).forward(trained["jqp"], jnp.asarray(ids),
                                                        trained["jcfg"],
                                                        linear_fn=jtq.qat_linear_fn)
    np.testing.assert_allclose(logits_qat.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    dense = ttq.export_dense(trained["tqp"], fam)
    assert all(isinstance(lp[n], dict) and not lp[n]["w"].requires_grad
               for lp in dense["layers"] for n in fam.linear_names)


def test_mean_bits_report_matches(trained):
    want = jtq.mean_bits_report(trained["jqp"], jfamily_for(trained["family"]))
    assert ttq.mean_bits_report(trained["tqp"], family_for(trained["family"])) == want


@pytest.mark.parametrize("steps,warmup_frac", [(4, 0.05), (10, 0.3), (100, 0.05), (3, 0.5)])
def test_lr_follows_optax_schedule(steps, warmup_frac):
    """The lr of each update, read as optax reads its count (before the
    increment): the first update at exactly 0."""
    qcfg = ttq.QATConfig(train_steps=steps, learning_rate=1e-3, warmup_frac=warmup_frac)
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, max(int(steps * warmup_frac), 1), steps)
    w = torch.zeros(2, requires_grad=True)
    params = {"layers": [{"q": tq.QATLinear(weight=w, bias=None,
                                           outlier_mask=torch.zeros(2, dtype=torch.bool))}]}
    opt, lr_sched = ttq.make_optimizer(qcfg, params)
    got = []
    for _ in range(steps + 2):
        got.append(opt.param_groups[0]["lr"])
        opt.step()
        lr_sched.step()
    want = [float(sched(c)) for c in range(steps + 2)]
    assert got[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=LR_RTOL, atol=LR_ATOL * 1e-3)


def test_first_update_is_at_lr_zero():
    _, _, tcfg, tp = _models("llama")
    fam = family_for("llama")
    qcfg = ttq.QATConfig(train_steps=STEPS, learning_rate=LR)
    tqp = ttq.replace_linears(tp, fam, qcfg)
    before = [q.weight.detach().clone() for q in ttq.qat_linears(tqp)]
    opt, sched = ttq.make_optimizer(qcfg, tqp)
    step = ttq.make_train_step(tcfg, fam, qcfg, opt, sched)
    step(tqp, {"input_ids": torch.from_numpy(_batches()[0]["input_ids"])})
    assert all(torch.equal(q.weight.detach(), b) for q, b in zip(ttq.qat_linears(tqp), before))
    assert all(q.weight.grad is not None and q.weight.grad.abs().max() > 0
               for q in ttq.qat_linears(tqp))
    assert opt.param_groups[0]["lr"] > 0.0


def test_causal_lm_loss_pad_mask():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
    ids = rng.integers(0, 11, size=(2, 7))
    mask = np.array([[1, 1, 1, 1, 0, 0, 0], [1] * 7])
    for m in (None, mask):
        want = float(jtq.causal_lm_loss(jnp.asarray(logits), jnp.asarray(ids),
                                        None if m is None else jnp.asarray(m)))
        got = float(ttq.causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(ids),
                                       None if m is None else torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# flash attention under autograd
# ---------------------------------------------------------------------------

def test_flash_wrapper_raises_under_grad():
    """The port's flash wrapper has no backward and raises under grad (on
    every device; the plain version it takes on the CPU is differentiable,
    the CUDA op is not); without grad it runs."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, 2, 8)).astype(np.float32))
               for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention(q.requires_grad_(), k, v, 0.35, causal=True)
    with torch.no_grad():
        out = tfa.flash_attention(q, k, v, 0.35, causal=True)
    assert out.shape == q.shape


def test_jax_flash_kernel_has_no_gradient():
    """The JAX kernel has no backward either: jax.value_and_grad through the
    Pallas flash kernel in interpret mode raises (in the pallas_call JVP
    rule), which is why the trainers of both packages take the masked
    softmax."""
    from pb_llm_tpu.ops.flash_attention import flash_attention

    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.standard_normal((1, 16, 2, 8)).astype(np.float32))
               for _ in range(3))

    def loss(q):
        return jnp.sum(flash_attention(q, k, v, 0.35, causal=True, interpret=True) ** 2)

    with pytest.raises(Exception):
        jax.value_and_grad(loss)(q)


def test_trainer_takes_masked_softmax_under_flash_config():
    """With attention "flash" configured around it, the trainer
    still runs (its layers enter attention="xla", also in remat's
    recompute), and q/k/v get gradient."""
    from pb_llm_tpu_torch.ops import kernel_config as kc

    _, _, tcfg, tp = _models("llama")
    fam = family_for("llama")
    qcfg = ttq.QATConfig(train_steps=STEPS, learning_rate=LR)
    tqp = ttq.replace_linears(tp, fam, qcfg)
    with kc.use_kernels(kc.KernelConfig(attention="flash")):
        opt, sched = ttq.make_optimizer(qcfg, tqp)
        step = ttq.make_train_step(tcfg, fam, qcfg, opt, sched)
        loss = step(tqp, {"input_ids": torch.from_numpy(_batches()[0]["input_ids"])})
    assert torch.isfinite(loss)
    for n in ("q_proj", "k_proj", "v_proj"):
        assert tqp["layers"][0][n].weight.grad.abs().max() > 0


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,percent,seqlen,batch", [
    ("red_pajama", 100, 64, 2), ("red_pajama", 50, 32, 3), ("english_quotes", 10, 48, 2),
    ("Abirate/english_quotes", 100, 2048, 4), ("c4", 40, 64, 2)])
def test_qat_dataset_batches_bit_identical(name, percent, seqlen, batch):
    jit = jget_qat_dataset(name, JByteTokenizer(), percent, seqlen=seqlen, batch_size=batch,
                           source=jsynthetic_source(n_docs=30, seed=2))
    tit = get_qat_dataset(name, ByteTokenizer(), percent, seqlen=seqlen, batch_size=batch,
                          source=synthetic_source(n_docs=30, seed=2))
    for _ in range(20):  # past the end of the permutation: the generator wraps
        jb, tb = next(jit), next(tit)
        assert sorted(jb) == sorted(tb) == ["attention_mask", "input_ids"]
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and np.array_equal(jb[k], tb[k])
