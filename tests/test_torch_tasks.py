"""Port parity for task scoring (`pb_llm_tpu_torch.eval.tasks`) against the
JAX package's `eval.tasks` on the CPU.

Bit for bit: the formatters' strings (the docs of tests/test_task_formats.py
and tests/test_data_eval.py as cases), the suite tables, `expand_tasks`,
`fewshot_prefix`, `apply_fewshot` (the same `random.Random(seed)` draws),
`_encode_pair` / `_prepare`'s ids.  Log-likelihoods within rtol 1e-5 /
atol 1e-5 (f32 forwards of 2 layers, hidden 32 / 64, summed in another
order than XLA's); greedy flags equal; accuracies equal.
"""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from pb_llm_tpu.eval import tasks as J
from pb_llm_tpu.models import llama as jllama
from pb_llm_tpu.models import opt as jopt
from pb_llm_tpu.models.registry import family_for as jfamily_for
from pb_llm_tpu_torch.eval import tasks as T
from pb_llm_tpu_torch.interop import from_jax_params
from pb_llm_tpu_torch.models import llama as tllama
from pb_llm_tpu_torch.models import opt as topt
from pb_llm_tpu_torch.models.registry import family_for

torch.set_num_threads(2)

LL_RTOL = LL_ATOL = 1e-5

DOCS = [
    ("boolq", {"passage": "The sky is blue.", "question": "is the sky blue", "answer": 1}),
    ("boolq", {"passage": "p", "question": "q", "answer": 0}),
    ("piqa", {"goal": "open a jar", "sol1": "twist the lid", "sol2": "hit it", "label": 0}),
    ("hellaswag", {
        "activity_label": "Removing ice from car",
        "ctx_a": "Then, the man writes over the snow covering the window of a car, and a woman "
                 "wearing winter clothes smiles.",
        "ctx_b": "then",
        "endings": [", the man adds wax to the windshield and cuts it.",
                    "does it. [title] He waves. Then [substeps] he stops."],
        "label": 1}),
    ("hellaswag", {"activity_label": "Baking", "ctx_a": "", "ctx_b": "", "ctx": "She  mixes [step] flour.",
                   "endings": ["  it  rises", "[x] it falls"], "label": "0"}),
    ("winogrande", {"sentence": "The trophy didn't fit in the case because _ was too big.",
                    "option1": "the trophy", "option2": "the case", "answer": "1"}),
    ("winogrande", {"sentence": "the _ ran", "option1": "dog", "option2": "cat", "answer": "2"}),
    ("arc_easy", {"question": "Which is a metal?", "answerKey": "3",
                  "choices": {"label": ["1", "2", "3", "4"],
                              "text": ["wood", "glass", "iron", "cloth"]}}),
    ("arc_challenge", {"question": "q", "choices": {"label": ["A", "B"], "text": ["x", "y"]},
                       "answerKey": "B"}),
    ("openbookqa", {"question_stem": "The sun is", "answerKey": "C ",
                    "choices": {"label": ["A", "B", "C", "D"],
                                "text": ["cold", "small", "a star", "wet"]}}),
    ("hendrycksTest-abstract_algebra", {"question": "  What is 2+2?  ",
                                        "choices": ["3", "4", "5", "6"], "answer": 1}),
    ("hendrycksTest-virology", {"question": "Q?", "choices": ["a", "b", "c", "d"], "answer": 2}),
]


@pytest.mark.parametrize("i", range(len(DOCS)), ids=[f"{t}-{i}" for i, (t, _) in enumerate(DOCS)])
def test_formatter_strings(i):
    task, doc = DOCS[i]
    got, want = T.TASK_FORMATTERS[task](doc), J.TASK_FORMATTERS[task](doc)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_task_tables_and_expansion():
    assert T.MMLU_SUBJECTS == J.MMLU_SUBJECTS and T.LLMQAT_SUITE == J.LLMQAT_SUITE
    assert sorted(T.TASK_FORMATTERS) == sorted(J.TASK_FORMATTERS)
    for tasks in (["mmlu"], ["llmqat"], ["boolq", "piqa"], ["mmlu", "boolq", "llmqat"], []):
        assert T.expand_tasks(tasks) == J.expand_tasks(tasks)
    assert [f.name for f in dataclasses.fields(T.TaskSpec)] == \
        [f.name for f in dataclasses.fields(J.TaskSpec)]


SHOTS = [("Q: 1+1\nA:", [" 2", " 3"], 0, None), ("Q: 2+2\nA:", [" 4", " 5"], 0, None),
         ("ctxA", [" tail", " tail"], 1, ["ctxA", "ctxB"])]


def _ex(mod, spec):
    return mod.Example(*spec)


@pytest.mark.parametrize("n,desc", [(0, ""), (1, ""), (2, ""), (3, "D"), (0, "Answer the question.")])
def test_fewshot_prefix_strings(n, desc):
    assert T.fewshot_prefix([_ex(T, s) for s in SHOTS[:n]], desc) == \
        J.fewshot_prefix([_ex(J, s) for s in SHOTS[:n]], desc)


def _queries(mod, n=7):
    out = []
    for i in range(n):
        if i % 3 == 2:  # winogrande-style per-choice contexts
            out.append(mod.Example(f"q{i}A", [" t", " t"], i % 2, contexts=[f"q{i}A", f"q{i}B"]))
        else:
            out.append(mod.Example(f"q{i}: what is {i}?", [" a", " b", " c"], i % 3))
    return out


@pytest.mark.parametrize("k,training,desc,seed", [
    (0, False, "", 42), (2, False, "", 42), (3, True, "", 42), (1, True, "Describe.", 7),
    (0, False, "Only a description.", 42), (6, False, "", 1), (10, True, "", 3)])
def test_apply_fewshot_strings(k, training, desc, seed):
    """The same shots in the same order: Python's random.Random(seed),
    consumed in JAX's order (with training docs rnd.sample(training, k),
    without rnd.sample(eval docs, k+1) minus the query)."""
    tr_t = [_ex(T, s) for s in SHOTS] if training else None
    tr_j = [_ex(J, s) for s in SHOTS] if training else None
    got = T.apply_fewshot(_queries(T), k, training=tr_t, seed=seed, description=desc)
    want = J.apply_fewshot(_queries(J), k, training=tr_j, seed=seed, description=desc)
    assert [dataclasses.asdict(e) for e in got] == [dataclasses.asdict(e) for e in want]


class MergeTokenizer:
    """BPE-like toy: 'ab' at a boundary tokenizes differently than 'a'+'b'."""

    eos_token_id = 0

    def encode(self, s, add_special_tokens=True):
        ids, i = [], 0
        while i < len(s):
            if s[i : i + 2] == "ab":
                ids.append(99)
                i += 2
            else:
                ids.append(ord(s[i]))
                i += 1
        return ids


class ByteTok:
    """No add_special_tokens keyword: the scorer's TypeError fallback."""

    eos_token_id = 1

    def encode(self, s):
        return [min(ord(c), 255) for c in s]


PAIRS = [("xa", "by"), ("hi ", "there"), ("hi  \n", "x"), ("", " yes"), ("abab", "ab"),
         ("the weather is", " nice"), ("z" * 70, " long"), ("y" * 300, " cut")]


@pytest.mark.parametrize("tok_cls", [MergeTokenizer, ByteTok])
def test_encode_pair_and_prepare_ids(tok_cls):
    kw = dict(buckets=(16, 64, 128))
    ts = T.LoglikelihoodScorer(None, None, None, tok_cls(), **kw)
    js = J.LoglikelihoodScorer(None, None, None, tok_cls(), **kw)
    for c, t in PAIRS:
        if c:
            assert ts._encode_pair(c, t) == js._encode_pair(c, t)
        got, want = ts._prepare(c, t), js._prepare(c, t)
        assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
        assert got[1] >= 1


def _opt_model(vocab=300):
    jcfg = jopt.OPTConfig(vocab_size=vocab, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
                          num_attention_heads=4, max_position_embeddings=2048)
    jp = jopt.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = topt.OPTConfig(**dataclasses.asdict(jcfg))
    return (jp, jcfg, jfamily_for("opt")), (from_jax_params(jax.tree_util.tree_map(np.asarray, jp)),
                                           tcfg, family_for("opt"))


def _llama_model():
    jcfg = jllama.LlamaConfig(vocab_size=300, hidden_size=64, intermediate_size=128,
                              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                              max_position_embeddings=160)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    return (jp, jcfg, jfamily_for("llama")), (from_jax_params(jax.tree_util.tree_map(np.asarray, jp)),
                                             tcfg, family_for("llama"))


@pytest.fixture(scope="module", params=["opt", "llama"])
def models(request):
    return _opt_model() if request.param == "opt" else _llama_model()


SCORE_PAIRS = [("the weather is", " nice"), ("the weather is", " bad"),
               ("a much longer context sentence that lands in the bigger bucket because it keeps "
                "going and going", " yes"), ("tiny", " x"), ("", " empty"), ("the weather is", " ok"),
               ("q" * 150, " truncated to the last bucket")]


def test_score_many_matches_jax(models):
    (jp, jcfg, jfam), (tp, tcfg, tfam) = models
    kw = dict(buckets=(32, 64, 128), max_batch=4)
    want = J.LoglikelihoodScorer(jp, jcfg, jfam, ByteTok(), **kw).score_many(SCORE_PAIRS)
    got = T.LoglikelihoodScorer(tp, tcfg, tfam, ByteTok(), **kw).score_many(SCORE_PAIRS)
    for (lg, gg), (lw, gw) in zip(got, want):
        np.testing.assert_allclose(lg, lw, rtol=LL_RTOL, atol=LL_ATOL)
        assert gg == gw


def test_score_many_batched_matches_sequential(models):
    _, (tp, tcfg, tfam) = models
    seq = T.LoglikelihoodScorer(tp, tcfg, tfam, ByteTok(), buckets=(32, 64, 128), max_batch=1)
    bat = T.LoglikelihoodScorer(tp, tcfg, tfam, ByteTok(), buckets=(32, 64, 128), max_batch=4)
    want = [seq.score(c, t) for c, t in SCORE_PAIRS]
    for (lg, gg), (lw, gw) in zip(bat.score_many(SCORE_PAIRS), want):
        np.testing.assert_allclose(lg, lw, rtol=LL_RTOL, atol=LL_ATOL)
        assert gg == gw


def test_vocab_limit_slices_logits():
    """A vocab larger than the limit: the slice raises each kept row's
    log-probability, as in JAX, to the same values."""
    (jp, jcfg, jfam), (tp, tcfg, tfam) = _opt_model()
    for limit in (None, 64):
        want, _ = J.LoglikelihoodScorer(jp, jcfg, jfam, ByteTok(), vocab_limit=limit).score("!#%", "+-")
        got, _ = T.LoglikelihoodScorer(tp, tcfg, tfam, ByteTok(), vocab_limit=limit).score("!#%", "+-")
        np.testing.assert_allclose(got, want, rtol=LL_RTOL, atol=LL_ATOL)
    cut = T.LoglikelihoodScorer(tp, tcfg, tfam, ByteTok(), vocab_limit=64).score("!#%", "+-")[0]
    full = T.LoglikelihoodScorer(tp, tcfg, tfam, ByteTok(), vocab_limit=None).score("!#%", "+-")[0]
    assert cut > full


def _mc_examples(mod):
    fmt = mod.TASK_FORMATTERS
    return {
        "boolq": [fmt["boolq"]({"passage": f"Passage {i} says so.", "question": f"is it {i}",
                                "answer": i % 2}) for i in range(4)],
        "winogrande": [fmt["winogrande"]({"sentence": f"The {w} saw the cat because _ was near.",
                                          "option1": "it", "option2": "the dog",
                                          "answer": str(1 + i % 2)})
                       for i, w in enumerate(["dog", "man", "boy"])],
        "hendrycksTest-anatomy": [fmt["hendrycksTest-anatomy"](
            {"question": f"Which bone number {i}?", "choices": ["femur", "tibia", "ulna", "skull"],
             "answer": i % 4}) for i in range(3)],
    }


@pytest.mark.parametrize("num_fewshot", [0, 2])
def test_evaluate_model_tasks_matches_jax(num_fewshot):
    (jp, jcfg, jfam), (tp, tcfg, tfam) = _opt_model()
    tasks = ["boolq", "winogrande", "hendrycksTest-anatomy"]
    want = J.evaluate_model_tasks(jp, jcfg, jfam, ByteTok(), tasks,
                                  examples_by_task=_mc_examples(J), num_fewshot=num_fewshot)
    got = T.evaluate_model_tasks(tp, tcfg, tfam, ByteTok(), tasks,
                                 examples_by_task=_mc_examples(T), num_fewshot=num_fewshot)
    assert got == want


def test_register_task_matches_jax():
    spec = dict(dataset="local/colors", split="test", context="Question: {question}\nAnswer:",
                choices_field="options", gold_field="answer", description="Colors.")
    docs = [{"question": "sky color?", "options": ["blue", "red"], "answer": 0},
            {"question": "grass color?", "options": ["red", "green"], "answer": "1"},
            {"question": "letter?", "options": {"text": ["x", "y"]}, "answer": "B"}]
    (jp, jcfg, jfam), (tp, tcfg, tfam) = _opt_model()
    T.register_task("colors_qa", T.TaskSpec(**spec))
    J.register_task("colors_qa", J.TaskSpec(**spec))
    try:
        assert T.expand_tasks(["colors_qa"]) == ["colors_qa"]
        texs = [T.TASK_FORMATTERS["colors_qa"](d) for d in docs]
        jexs = [J.TASK_FORMATTERS["colors_qa"](d) for d in docs]
        assert [dataclasses.asdict(e) for e in texs] == [dataclasses.asdict(e) for e in jexs]
        got = T.evaluate_model_tasks(tp, tcfg, tfam, ByteTok(), ["colors_qa"],
                                     examples_by_task={"colors_qa": texs}, num_fewshot=1)
        want = J.evaluate_model_tasks(jp, jcfg, jfam, ByteTok(), ["colors_qa"],
                                      examples_by_task={"colors_qa": jexs}, num_fewshot=1)
        assert got == want and got["results"]["colors_qa"]["n"] == 3
    finally:
        for mod in (T, J):
            mod.TASK_SPECS.pop("colors_qa", None)
            mod.TASK_FORMATTERS.pop("colors_qa", None)


def test_load_task_examples_without_datasets_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="datasets"):
        T.load_task_examples("boolq")
    with pytest.raises(ImportError, match="examples_by_task"):
        T.evaluate_model_tasks(None, None, None, ByteTok(), ["boolq"])
