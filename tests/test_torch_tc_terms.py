"""The bf16 term schemes of the select and flash kernels' tensor-core arms
("tc"), fixed on the CPU.

Each arm carries f32 operands in bf16 terms (`ops.bf16_terms.split`) and
issues a list of term products (`packed_matmul_v1.SELECT_TERMS`,
`flash_attention.FLASH_TERMS`).  An emulation does in plain PyTorch what
the kernel does: the split, each product exact (f64), each stage's fresh
partial (the tensor cores' in-stage sum, emulated exactly and rounded once
to f32), the partials joined in the kernel's order with single f32
roundings.  Held against the plain versions on the CPU:

- the chosen products keep the emulation within a third of the kernels'
  bounds (select: rtol = atol = 1e-4 on y; flash: out and l 1e-4, the
  running max m 1e-5), and every list one product shorter misses that (or,
  for select, no longer reads an identity x's weight back bit for bit);
- with an identity x the select emulation returns `select_weight(p)` bit
  for bit;
- the arm rules follow their constants; the kernel's index arithmetic (its
  x column order, the sidecar box rows and swizzle, the group of a weight)
  replayed in integers reads the packed planes as the plain version does;
- the plain flash at a head dim the tc arm pads (40) matches the JAX
  package's kernel in interpret mode.

The tensor cores' own f32 sums inside a stage (which truncate) are not
emulated: the card tests hold the kernels to the same bounds
(tests/test_torch_cuda_kernels.py).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.ops.flash_attention import flash_attention as jflash
from pb_llm_tpu_torch.core import packing
from pb_llm_tpu_torch.core.pbw import sidecar_codes
from pb_llm_tpu_torch.data.synthetic import random_packed_v1
from pb_llm_tpu_torch.ops import bf16_terms
from pb_llm_tpu_torch.ops import flash_attention as tfa
from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

torch.set_num_threads(2)

THIRD = 1.0 / 3.0
STAGE_K = 64  # the select arm's stage: two sign words


def _ratio(got, want, rtol, atol):
    """max |got - want| / (atol + rtol |want|): 1 is the bound."""
    return ((got.double() - want.double()).abs() / (atol + rtol * want.double().abs())).max().item()


def _without(products, drop):
    return tuple(pr for pr in products if pr != drop)


# ---------------------------------------------------------------------------
# select
# ---------------------------------------------------------------------------

def _select_emulated(x, p, schemes):
    """The tc arm's f32 dot on x [m, ic] for each product list in
    ``schemes``: x and w in three bf16 terms in the kernel's column order,
    per stage of 64 columns the listed products summed exactly and rounded
    once, the stages joined in order in f32, then the bias."""
    order = v1.tc_x_order(p.ic_local, p.pack_block_local)
    xs = bf16_terms.split(x.float()[:, order], 3).double()
    ws = bf16_terms.split(v1.select_weight(p)[order], 3).double()
    pairs = sorted({pr for s in schemes for pr in s})
    accs = [torch.zeros((x.shape[0], p.oc_local)) for _ in schemes]
    for k0 in range(0, p.ic_local, STAGE_K):
        part = {(i, j): xs[i][:, k0:k0 + STAGE_K] @ ws[j][k0:k0 + STAGE_K] for i, j in pairs}
        for acc, s in zip(accs, schemes):
            acc += sum(part[pr] for pr in s).float()
    return [acc + p.bias if p.bias is not None else acc for acc in accs]


@pytest.fixture(scope="module")
def select_ratios():
    """For OPT-1.3B's fc1 and fc2 shapes at 64 rows: the emulation's ratio to
    the bound for SELECT_TERMS and for each list one product shorter."""
    schemes = [v1.SELECT_TERMS] + [_without(v1.SELECT_TERMS, d) for d in v1.SELECT_TERMS]
    out = {}
    for ic, oc in ((2048, 8192), (8192, 2048)):
        p = random_packed_v1(ic, oc, torch.Generator().manual_seed(ic), low_frac=0.9, bias=True)
        x = torch.from_numpy(np.random.default_rng(ic).standard_normal((64, ic), np.float32))
        want = v1.pb_select_v1_plain(x, p)
        out[ic, oc] = [_ratio(g, want, 1e-4, 1e-4) for g in _select_emulated(x, p, schemes)]
    return out


@pytest.mark.parametrize("shape", [(2048, 8192), (8192, 2048)])
def test_select_terms_stay_within_a_third_of_the_bound(select_ratios, shape):
    assert select_ratios[shape][0] <= THIRD, select_ratios[shape]


@pytest.mark.parametrize("drop", v1.SELECT_TERMS)
def test_select_one_product_fewer_misses(select_ratios, drop):
    """Without (1, 0), (0, 1) or (0, 0) the error grows by 10^2-10^4; without
    one of the second-order products ((2, 0), (1, 1), (0, 2)) it passes a
    third of the bound on both shapes (0.57-1.01 of it, against 0.08-0.15
    with all six); and without (0, 2) an identity x no longer reads w back
    (test below)."""
    k = 1 + v1.SELECT_TERMS.index(drop)
    worst = max(r[k] for r in select_ratios.values())
    assert worst > THIRD, (drop, select_ratios)


@pytest.mark.parametrize("name,kw", [
    ("groups_nibbles_low2", dict(groupsize=128, sidecar_bits=4, low_bits=2)),
    ("whole_row", dict()),
])
def test_select_emulation_reads_an_identity_back_bit_for_bit(name, kw):
    """An identity x is one exact term: the products of x's first term with
    w's three terms sum to w exactly, so every row of y is a row of
    `select_weight(p)`, bit for bit.  Dropping (0, 2) loses w's last bits."""
    p = random_packed_v1(512, 256, torch.Generator().manual_seed(5), **kw)
    eye = torch.eye(p.ic)
    got, short = _select_emulated(eye, p, [v1.SELECT_TERMS, _without(v1.SELECT_TERMS, (0, 2))])
    w = v1.select_weight(p)
    assert torch.equal(got, w)
    assert not torch.equal(short, w)


def test_select_bf16_dot_is_one_product_of_the_plain_roundings():
    """A bf16 dot's single product reads bf16(x) and bf16(w), the plain
    version's roundings: the emulation equals the plain version up to the
    f32 summation order."""
    p = random_packed_v1(512, 256, torch.Generator().manual_seed(6), bias=True)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((16, 512), np.float32))
    assert v1.select_products(torch.bfloat16) == ((0, 0),)
    assert bf16_terms.split(x, 1)[0].equal(x.to(torch.bfloat16))
    got = _select_emulated(x.to(torch.bfloat16).float(), p, [((0, 0),)])[0]
    want = v1.pb_select_v1_plain(x, p, torch.bfloat16)
    assert _ratio(got, want, 1e-4, 1e-4) <= THIRD


def test_select_arm_follows_select_tc(monkeypatch):
    p = random_packed_v1(256, 128, torch.Generator().manual_seed(0))
    for tc in (1, 256, 1024):
        monkeypatch.setattr(v1, "SELECT_TC", tc)
        for m in (1, 8, 64, 255, 256, 512, 8192):
            assert v1.select_arm(m, p) == ("tc" if m >= tc else "cores")


@pytest.mark.parametrize("m", [1, 64, 256, 512, 8192])
@pytest.mark.parametrize("ic,oc", [(2048, 2048), (8192, 2048), (4096, 11008)])
def test_select_ksplit_fills_the_card_in_long_ranges(ic, oc, m):
    """Arm "tc"'s K split: a grid short of the multiprocessors takes more
    K ranges, none shorter than SPLIT_MIN_STAGES stages of 64 rows, and no
    more blocks than the card holds at once."""
    p = types.SimpleNamespace(ic_local=ic, oc_local=oc)  # all the rule reads of a layer
    blocks = (oc // 128) * -(-m // 128)
    k = v1.select_ksplit(m, p, 132)
    assert k >= 1 and (k == 1 or (ic // 64) // k >= v1.SPLIT_MIN_STAGES)
    assert k == 1 or blocks * k <= 132
    if blocks >= 132:
        assert k == 1


@pytest.mark.parametrize("name,kw", [
    ("whole_row", dict(ic=512)),
    ("groups_nibbles_low2", dict(ic=512, groupsize=128, sidecar_bits=4, low_bits=2)),
    ("odd_words", dict(ic=1376, low_bits=4)),  # 43 words a block: a stage straddles two
    ("groups_in_blocks", dict(ic=1024, groupsize=64, pack_block=512, sidecar_bits=4)),
])
def test_select_tc_index_arithmetic_reads_the_planes(name, kw):
    """csrc/pb_select_v1.cu's tc arm replayed in integers: x column k =
    32*W + b of `tc_x_order`, the sign and mask bit b of word W, the sidecar
    byte of row b of word W's TMA box (4-d: [blocks][SR][g][oc]) or its
    nibble, the scale group of the weight's row.  Each reads what the plain
    version's unpacked planes hold at that weight row."""
    p = random_packed_v1(oc=128, generator=torch.Generator().manual_seed(7), **kw)
    assert v1.kernel_supported_v1(p)
    ic, g = p.ic, min(p.ic, p.pack_block) // 32
    order = v1.tc_x_order(ic, p.pack_block)
    assert torch.equal(order.sort().values, torch.arange(ic))
    k = torch.arange(ic)
    w, b = k // 32, k % 32
    blk, i = w // g, w % g
    row = blk * 32 * g + b * g + i           # the kernel's row0 + b*g
    assert torch.equal(row, order)
    # sign and mask: bit b of word W (words are global: blk*g + i)
    sign = p.sign_packed.long() & 0xFFFFFFFF
    nwords = ic // 32
    code = sum(((sign[j * nwords + w] >> b[:, None]) & 1) << j for j in range(p.low_bits))
    assert torch.equal(code.float(), v1.low_code(p.sign_packed, p.low_bits, ic, p.pack_block)[row])
    mask = (p.mask_packed.long() & 0xFFFFFFFF)[w] >> b[:, None] & 1
    assert torch.equal(mask, packing.unpack_bits(p.mask_packed, ic, p.pack_block)[row].long())
    # the sidecar box of word W: its row r = b (nibbles: b % 16, nibble b // 16)
    # is sidecar row blk*SR*g + r*g + i
    sr = 32 if p.sidecar_bits == 8 else 16
    r = b if sr == 32 else b % 16
    v = p.sidecar.long()[blk * sr * g + r * g + i]
    if sr == 16:
        v = torch.where(b[:, None] >= 16, v >> 4, v & 15)
    assert torch.equal(v, sidecar_codes(p).long()[row])
    # the scale group: per word where a pack block lies in one group, else per weight
    gi = torch.clamp(row // p.groupsize_local, max=p.n_groups - 1)
    if p.groupsize_local >= 32 * g:
        assert torch.equal(gi, torch.clamp((blk * 32 * g + i) // p.groupsize_local,
                                           max=p.n_groups - 1))
    scale = torch.repeat_interleave(p.low_scale, p.groupsize_local, dim=0)[:ic]
    assert torch.equal(p.low_scale[gi], scale[row])


# ---------------------------------------------------------------------------
# flash
# ---------------------------------------------------------------------------

FLASH_SHAPE = (512, 2, 128)  # T, H, D (B = 1)
FLASH_DRAWS = tuple(range(8))


def _flash_emulated(q, k, v, scale, causal, qk, pv, tile=64):
    """The tc arm on q, k, v [T, H, D] (B = 1, every key allowed up to the
    causal limit): per key tile, S from the ``qk`` products of q's and k's
    three terms (exact, rounded once), the online softmax in f32, P in two
    terms, the tile's P.V from the ``pv`` products (exact, rounded once)
    joined as fma(O, alpha, partial)."""
    t, h, d = q.shape
    qs, ks = (bf16_terms.split(a, 3).double() for a in (q, k))
    vs = bf16_terms.split(v, 2).double()
    m = torch.full((h, t), tfa.NEG_INF)
    l = torch.zeros((h, t))
    o = torch.zeros((h, t, d))
    qpos = torch.arange(t)[:, None]
    for k0 in range(0, k.shape[0], tile):
        sl = slice(k0, k0 + tile)
        s = sum(torch.einsum("thd,shd->hts", qs[i], ks[j][sl]) for i, j in qk).float() * scale
        ok = torch.arange(k0, k0 + s.shape[-1])[None, :] <= qpos if causal else torch.ones(
            (t, s.shape[-1]), dtype=torch.bool)
        s = torch.where(ok, s, tfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        pr = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        l = alpha * l + pr.sum(-1)
        ps = bf16_terms.split(pr, 2).double()
        part = sum(torch.einsum("hts,shd->htd", ps[i], vs[j][sl]) for i, j in pv)
        o = (o.double() * alpha.double()[..., None] + part).float()
        m = m_new
    inv = torch.where(l == 0, 1.0, 1.0 / l)
    return (o * inv[..., None]).permute(1, 0, 2), m.t(), l.t()


@pytest.fixture(scope="module")
def flash_ratios():
    """Per product-list pair, the worst ratio to the bound over the draws and
    causal / not: (out, m, l), against flash_attention_plain."""
    qk, pv = tfa.FLASH_TERMS
    pairs = {"chosen": (qk, pv)}
    pairs.update({("qk", d): (_without(qk, d), pv) for d in qk})
    pairs.update({("pv", d): (qk, _without(pv, d)) for d in pv})
    worst = {name: [0.0, 0.0, 0.0] for name in pairs}
    t, h, d = FLASH_SHAPE
    for seed in FLASH_DRAWS:
        r = np.random.default_rng(100 + seed)
        q, k, v = (torch.from_numpy(r.standard_normal((t, h, d), np.float32)) for _ in range(3))
        for causal in (True, False):
            want = tfa.flash_attention_plain(q[None], k[None], v[None], d ** -0.5, causal=causal,
                                             return_residuals=True)
            for name, (a, b) in pairs.items():
                got = _flash_emulated(q, k, v, d ** -0.5, causal, a, b)
                for n, (g, w, tol) in enumerate(zip(got, want, (1e-4, 1e-5, 1e-4))):
                    worst[name][n] = max(worst[name][n], _ratio(g, w[0], tol, tol))
    return worst


def test_flash_terms_stay_within_a_third_of_the_bounds(flash_ratios):
    assert max(flash_ratios["chosen"]) <= THIRD, flash_ratios["chosen"]


@pytest.mark.parametrize("which,drop", [("qk", d) for d in tfa.FLASH_TERMS[0]]
                         + [("pv", d) for d in tfa.FLASH_TERMS[1]])
def test_flash_one_product_fewer_misses(flash_ratios, which, drop):
    """Without a first-order product the error grows by 10-10^5; without one
    of S's second-order products ((2, 0), (1, 1), (0, 2)) the running max m
    passes a third of its 1e-5 bound on some draw (0.39-0.48 of it at worst
    over the eight draws, against 0.06 with all six)."""
    assert max(flash_ratios[which, drop]) > THIRD, (which, drop, flash_ratios)


def test_flash_arm_rule():
    assert tfa.flash_arm() == "tc" and tfa.flash_arm(None) == "tc"
    assert tfa.flash_arm("cores") == "cores" and tfa.flash_arm("tc") == "tc"
    with pytest.raises(ValueError, match="arm"):
        tfa.flash_arm("plain")
    assert tfa.tc_products(True) == (((0, 0),), ((0, 0),))
    assert tfa.tc_products(False) == tfa.FLASH_TERMS


def test_flash_tc_terms_plain_pads_and_transposes():
    """The tc arm's scratch as its plain version lays it out: head dim 40
    padded with zeros to 64, v transposed with keys padded to 8; q's three
    terms sum back to q exactly, v's two to `bf16_terms.split`'s sum."""
    r = np.random.default_rng(8)
    q = torch.from_numpy(r.standard_normal((2, 10, 3, 40), np.float32))
    k, v = (torch.from_numpy(r.standard_normal((2, 13, 3, 40), np.float32)) for _ in range(2))
    qt, kt, vt = tfa.tc_terms_plain(q, k, v)
    assert [tuple(a.shape) for a in (qt, kt, vt)] == list(tfa.tc_scratch(2, 10, 13, 3, 40, False))
    got_q = qt.double().sum(0).reshape(2, 3, 10, 64)[..., :40].permute(0, 2, 1, 3)
    assert torch.equal(got_q, q.double())
    got_v = vt.double().sum(0)[:, :40, :13].reshape(2, 3, 40, 13).permute(0, 3, 1, 2)
    assert torch.equal(got_v, bf16_terms.split(v, 2).double().sum(0))
    assert not qt[..., 40:].any() and not vt[:, :, 40:].any() and not vt[..., 13:].any()


def test_flash_plain_matches_jax_kernel_at_a_padded_head_dim():
    """d = 40, which the tc arm pads to 64: the plain version (the tc arm's
    oracle on the card) against the JAX kernel in interpret mode."""
    r = np.random.default_rng(9)
    q, k, v = (r.standard_normal((1, 100, 2, 40)).astype(np.float32) for _ in range(3))
    scale = 40 ** -0.5
    want, wm, wl = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal=True,
                          block_q=64, block_k=64, interpret=True, return_residuals=True)
    got, m, l = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), scale,
                                    return_residuals=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(m.numpy(), np.asarray(wm), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(wl), atol=1e-4, rtol=1e-4)
