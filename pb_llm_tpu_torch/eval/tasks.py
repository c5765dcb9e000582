"""Multiple-choice task evaluation (port of `pb_llm_tpu/eval/tasks.py`): the
lm-eval v0.3 adapter the reference wraps (`evaluate.py:11-84,165-182`),
with the suite expansion "mmlu" → 57 `hendrycksTest-*` subtasks and
"llmqat" → boolq,piqa,hellaswag,winogrande,arc_easy,arc_challenge,openbookqa
(`evaluate.py:160-163`):

  * every task is a list of (context, choices, gold) examples,
  * each choice is scored by the summed log-likelihood of its tokens given
    the context (the lm-eval `loglikelihood` request),
  * accuracy = argmax-choice == gold; the mean over tasks reported like
    `evaluate.py:173-182`.

Prompt templates follow lm-eval v0.3's default formats; few-shot shots are
drawn with Python's `random.Random(seed)` in JAX's order, so they are the
same strings.  The scorer's forward runs under `torch.inference_mode` on
the model's device, one call per (bucket, batch).  Dataset loading needs
the `datasets` package and a network or a populated cache; offline, pass
``examples_by_task``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class Example:
    context: str
    choices: List[str]
    gold: int
    # Per-choice contexts (winogrande-style: the *context* varies per option
    # and the continuation is shared); overrides `context` when set.
    contexts: Optional[List[str]] = None


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------


def _bucket(n: int, buckets: Sequence[int]):
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class LoglikelihoodScorer:
    """Batched log-likelihood of continuations, padded to length buckets
    (the EvalLM adapter's `_model_call` role, `evaluate.py:75-84`)."""

    def __init__(self, params, cfg, fam, tokenizer, buckets=(64, 128, 256, 512, 1024, 2048),
                 vocab_limit: Optional[int] = None, max_batch: int = 8):
        """``vocab_limit``: slice logits to the first N entries before scoring
        (the reference slices to 50257, `evaluate.py:79`).  ``max_batch``:
        requests per forward in `score_many`."""
        self.params, self.cfg, self.fam, self.tok = params, cfg, fam, tokenizer
        self.buckets = buckets
        self.vocab_limit = vocab_limit
        self.max_batch = max_batch

    def _loglik(self, ids: torch.Tensor, cont_start: torch.Tensor, cont_len: torch.Tensor):
        """ids [B, blen]; cont_start / cont_len [B] → (summed continuation
        log-likelihood [B] f32, continuation all greedy [B] bool)."""
        with torch.inference_mode():
            logits, _ = self.fam.forward(self.params, ids, self.cfg)
            if self.vocab_limit is not None:
                logits = logits[:, :, : self.vocab_limit]
            lp = torch.log_softmax(logits.float(), dim=-1)
            pos = torch.arange(ids.shape[1], device=ids.device)
            tgt_lp = torch.gather(lp[:, :-1], -1, ids[:, 1:, None])[..., 0]
            in_cont = ((pos[None, 1:] >= cont_start[:, None])
                       & (pos[None, 1:] < (cont_start + cont_len)[:, None]))
            greedy = torch.argmax(lp[:, :-1], dim=-1) == ids[:, 1:]
            return (torch.sum(torch.where(in_cont, tgt_lp, 0.0), dim=1),
                    torch.all(torch.where(in_cont, greedy, True), dim=1))

    def _encode(self, s: str) -> List[int]:
        # lm-eval v0.3 tok_encode uses add_special_tokens=False (evaluate.py:64-65)
        try:
            return list(self.tok.encode(s, add_special_tokens=False))
        except TypeError:
            return list(self.tok.encode(s))

    def _encode_pair(self, context: str, continuation: str) -> tuple[List[int], List[int]]:
        """lm-eval v0.3 BaseLM._encode_pair: trailing context whitespace moves
        into the continuation, and the continuation tokens are the suffix of
        the *jointly* tokenized string (so BPE merges across the boundary are
        attributed to the continuation)."""
        n_spaces = len(context) - len(context.rstrip())
        if n_spaces > 0:
            continuation = context[-n_spaces:] + continuation
            context = context[:-n_spaces]
        whole = self._encode(context + continuation)
        ctx = self._encode(context)
        return ctx, whole[len(ctx) :]

    def _prepare(self, context: str, continuation: str):
        if context == "":
            eot = getattr(self.tok, "eos_token_id", None) or 0
            ctx, cont = [eot], self._encode(continuation)
        else:
            ctx, cont = self._encode_pair(context, continuation)
        # v0.3 truncation: inp = (ctx+cont)[-(max_length+1):][:-1]; the full
        # window is fed (the extra final logit is unused by the causal mask)
        ids = (ctx + cont)[-(self.buckets[-1]) :]
        cont_start = max(len(ids) - len(cont), 1)  # keep >=1 conditioning token
        blen = _bucket(len(ids), self.buckets)
        padded = np.zeros(blen, np.int64)
        padded[: len(ids)] = ids
        return padded, cont_start, len(cont), blen

    def score(self, context: str, continuation: str) -> tuple[float, bool]:
        return self.score_many([(context, continuation)])[0]

    def score_many(self, pairs) -> List[tuple[float, bool]]:
        """Score (context, continuation) pairs with same-bucket requests
        batched into one forward (up to ``max_batch``, padded to a power of
        two by repeating row 0).  Row-wise the same numbers as one at a
        time, up to the forward's batch-dependent rounding."""
        prep = [self._prepare(c, t) for c, t in pairs]
        out: List[Any] = [None] * len(pairs)
        by_bucket: Dict[int, List[int]] = {}
        for i, (_, _, _, blen) in enumerate(prep):
            by_bucket.setdefault(blen, []).append(i)
        device = self.params["embed_tokens"].device
        for blen, idxs in by_bucket.items():
            for lo in range(0, len(idxs), self.max_batch):
                group = idxs[lo : lo + self.max_batch]
                bsize = 1
                while bsize < len(group):
                    bsize *= 2
                rows = group + [group[0]] * (bsize - len(group))
                ids = torch.as_tensor(np.stack([prep[i][0] for i in rows]), device=device)
                cs = torch.as_tensor([prep[i][1] for i in rows], device=device)
                cl = torch.as_tensor([prep[i][2] for i in rows], device=device)
                lls, greedy = self._loglik(ids, cs, cl)
                lls, greedy = lls.cpu().numpy(), greedy.cpu().numpy()
                for r, i in enumerate(group):
                    out[i] = (float(lls[r]), bool(greedy[r]))
        return out


# ---------------------------------------------------------------------------
# few-shot (lm-eval v0.3 `Task.fewshot_context` semantics)
# ---------------------------------------------------------------------------


def _example_text(ex: Example) -> str:
    """doc_to_text of an example — the context shown before the answer (for
    per-choice-context tasks, the GOLD option's context, like v0.3
    winogrande's partial_context of the answer)."""
    return ex.contexts[ex.gold] if ex.contexts is not None else ex.context


def _example_target(ex: Example) -> str:
    """doc_to_target — the gold continuation text."""
    return ex.choices[ex.gold]


def fewshot_prefix(shots: Sequence[Example], description: str = "") -> str:
    """The labeled-examples block of lm-eval v0.3 `fewshot_context`
    (`lm_eval/base.py`): optional description + "\\n\\n", then each shot as
    doc_to_text + doc_to_target joined by "\\n\\n", then "\\n\\n" before the
    query."""
    desc = description + "\n\n" if description else ""
    if not shots:
        return desc
    labeled = "\n\n".join(_example_text(s) + _example_target(s) for s in shots)
    return desc + labeled + "\n\n"


def apply_fewshot(
    examples: Sequence[Example],
    num_fewshot: int,
    training: Optional[Sequence[Example]] = None,
    seed: int = 42,
    description: str = "",
) -> List[Example]:
    """Prefix every example's context(s) with ``num_fewshot`` labeled shots.

    Sampling follows v0.3: one `random.Random(seed)` consumed sequentially
    over the doc loop; with training docs, `rnd.sample(training, k)` per
    query; without, `rnd.sample(eval_docs, k+1)` minus the query itself,
    truncated to k (`lm_eval/base.py fewshot_examples`/`fewshot_context`).
    """
    if num_fewshot <= 0 and not description:
        return list(examples)
    import random

    rnd = random.Random(seed)
    out: List[Example] = []
    pool = list(training) if training else None
    for ex in examples:
        if num_fewshot <= 0:
            shots: List[Example] = []
        elif pool is not None:
            shots = rnd.sample(pool, min(num_fewshot, len(pool)))
        else:
            cand = rnd.sample(list(examples), min(num_fewshot + 1, len(examples)))
            shots = [c for c in cand if c is not ex][:num_fewshot]
        prefix = fewshot_prefix(shots, description)
        if ex.contexts is not None:
            out.append(dataclasses.replace(
                ex, context=prefix + ex.context,
                contexts=[prefix + c for c in ex.contexts]))
        else:
            out.append(dataclasses.replace(ex, context=prefix + ex.context))
    return out


def evaluate_task(scorer: LoglikelihoodScorer, examples: Sequence[Example], limit: int = -1,
                  num_fewshot: int = 0, training: Optional[Sequence[Example]] = None,
                  description: str = "") -> Dict[str, float]:
    if limit and limit > 0:
        examples = examples[:limit]
    if num_fewshot > 0 or description:
        examples = apply_fewshot(examples, num_fewshot, training=training,
                                 description=description)
    # flatten every (context, continuation) across examples so same-bucket
    # requests share forwards (score_many)
    pairs, spans = [], []
    for ex in examples:
        start = len(pairs)
        if ex.contexts is not None:  # winogrande-style: context varies per option
            pairs.extend((ctx, ex.choices[i]) for i, ctx in enumerate(ex.contexts))
        else:
            pairs.extend((ex.context, ch) for ch in ex.choices)
        spans.append((start, len(pairs)))
    scored = scorer.score_many(pairs)
    correct = 0
    for ex, (lo, hi) in zip(examples, spans):
        lls = [scored[i][0] for i in range(lo, hi)]
        correct += int(int(np.argmax(lls)) == ex.gold)
    n = max(len(examples), 1)
    return {"acc": correct / n, "n": n}


# ---------------------------------------------------------------------------
# task formatters (lm-eval v0.3 default prompts)
# ---------------------------------------------------------------------------


def fmt_boolq(doc) -> Example:
    ctx = f"{doc['passage']}\nQuestion: {doc['question']}?\nAnswer:"
    return Example(ctx, [" no", " yes"], int(doc["answer"]))


def fmt_piqa(doc) -> Example:
    return Example(f"Question: {doc['goal']}\nAnswer:", [" " + doc["sol1"], " " + doc["sol2"]], int(doc["label"]))


def _hellaswag_preprocess(text: str) -> str:
    """lm-eval v0.3 hellaswag.preprocess: strip, drop wikihow [title]/[step]
    artifacts, collapse double spaces."""
    import re

    text = text.strip()
    text = text.replace(" [title]", ". ")
    text = re.sub("\\[.*?\\]", "", text)
    text = text.replace("  ", " ")
    return text


def fmt_hellaswag(doc) -> Example:
    ctx = doc["ctx_a"] + " " + doc["ctx_b"].capitalize() if doc.get("ctx_b") else doc["ctx"]
    query = _hellaswag_preprocess(doc["activity_label"] + ": " + ctx)
    choices = [" " + _hellaswag_preprocess(e) for e in doc["endings"]]
    return Example(query, choices, int(doc["label"]))


def fmt_winogrande(doc) -> Example:
    """v0.3 winogrande scores the SHARED suffix as the continuation under each
    option-substituted context (partial_context/partial_target), not the
    option under a shared prefix."""
    idx = doc["sentence"].index("_")
    prefix = doc["sentence"][:idx]
    target = " " + doc["sentence"][idx + 1 :].strip()
    contexts = [prefix + doc["option1"], prefix + doc["option2"]]
    return Example(contexts[0], [target, target], int(doc["answer"]) - 1, contexts=contexts)


_ARC_NUM_TO_LETTER = {"1": "A", "2": "B", "3": "C", "4": "D", "5": "E"}


def fmt_arc(doc) -> Example:
    ctx = f"Question: {doc['question']}\nAnswer:"
    key = _ARC_NUM_TO_LETTER.get(doc["answerKey"], doc["answerKey"])
    gold = ["A", "B", "C", "D", "E"].index(key)
    return Example(ctx, [" " + t for t in doc["choices"]["text"]], gold)


def fmt_openbookqa(doc) -> Example:
    gold = ["A", "B", "C", "D"].index(doc["answerKey"].strip())
    return Example(doc["question_stem"], [" " + t for t in doc["choices"]["text"]], gold)


def fmt_mmlu(doc) -> Example:
    """v0.3 hendrycksTest.format_example: stripped question, lettered choice
    lines, continuations are the letters."""
    letters = ["A", "B", "C", "D"]
    ctx = doc["question"].strip() + "\n"
    for letter, choice in zip(letters, doc["choices"]):
        ctx += f"{letter}. {choice}\n"
    ctx += "Answer:"
    return Example(ctx, [f" {letter}" for letter in letters], int(doc["answer"]))


MMLU_SUBJECTS = [
    "abstract_algebra", "anatomy", "astronomy", "business_ethics", "clinical_knowledge",
    "college_biology", "college_chemistry", "college_computer_science", "college_mathematics",
    "college_medicine", "college_physics", "computer_security", "conceptual_physics",
    "econometrics", "electrical_engineering", "elementary_mathematics", "formal_logic",
    "global_facts", "high_school_biology", "high_school_chemistry", "high_school_computer_science",
    "high_school_european_history", "high_school_geography", "high_school_government_and_politics",
    "high_school_macroeconomics", "high_school_mathematics", "high_school_microeconomics",
    "high_school_physics", "high_school_psychology", "high_school_statistics",
    "high_school_us_history", "high_school_world_history", "human_aging", "human_sexuality",
    "international_law", "jurisprudence", "logical_fallacies", "machine_learning", "management",
    "marketing", "medical_genetics", "miscellaneous", "moral_disputes", "moral_scenarios",
    "nutrition", "philosophy", "prehistory", "professional_accounting", "professional_law",
    "professional_medicine", "professional_psychology", "public_relations", "security_studies",
    "sociology", "us_foreign_policy", "virology", "world_religions",
]

TASK_FORMATTERS: Dict[str, Callable] = {
    "boolq": fmt_boolq,
    "piqa": fmt_piqa,
    "hellaswag": fmt_hellaswag,
    "winogrande": fmt_winogrande,
    "arc_easy": fmt_arc,
    "arc_challenge": fmt_arc,
    "openbookqa": fmt_openbookqa,
    **{f"hendrycksTest-{s}": fmt_mmlu for s in MMLU_SUBJECTS},
}

LLMQAT_SUITE = ["boolq", "piqa", "hellaswag", "winogrande", "arc_easy", "arc_challenge", "openbookqa"]


# ---------------------------------------------------------------------------
# declarative task registry — new tasks without code.
# The reference passes arbitrary task names through to lm-eval's registry
# (`evaluate.py:165-172`); here a TaskSpec declares the
# dataset + field mapping + templates and `register_task` makes the name
# first-class (expand_tasks / load_task_examples / run_eval --tasks).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TaskSpec:
    """Declarative multiple-choice task.

    ``context`` is a str.format template over the doc's fields.  Choices come
    either from ``choices`` (a list of templates, e.g. [" yes", " no"] or
    [" {sol1}", " {sol2}"]) or from ``choices_field`` (a doc field holding a
    list of strings, each prefixed with ``choice_prefix``).  ``gold_field``
    may hold an int index, a digit string, or a letter (resolved through
    ``gold_letters``)."""

    dataset: str                        # HF datasets path (or any id for offline use)
    subset: Optional[str] = None
    split: str = "validation"
    train_split: Optional[str] = None   # few-shot sampling pool
    context: str = "{question}"
    choices: Optional[List[str]] = None
    choices_field: str = ""
    choice_prefix: str = " "
    gold_field: str = "label"
    gold_letters: str = "ABCDE"
    description: str = ""


TASK_SPECS: Dict[str, TaskSpec] = {}


def make_formatter(spec: TaskSpec) -> Callable[[dict], Example]:
    def fmt(doc) -> Example:
        ctx = spec.context.format(**doc)
        if spec.choices is not None:
            choices = [c.format(**doc) for c in spec.choices]
        else:
            raw = doc[spec.choices_field]
            if isinstance(raw, dict):
                raw = raw.get("text", raw)
            choices = [spec.choice_prefix + str(c) for c in raw]
        gold = doc[spec.gold_field]
        if isinstance(gold, str):
            gold = int(gold) if gold.strip().isdigit() else spec.gold_letters.index(gold.strip())
        return Example(ctx, choices, int(gold))

    return fmt


def register_task(name: str, spec: TaskSpec) -> None:
    """Make a declarative task name usable everywhere a built-in is."""
    TASK_SPECS[name] = spec
    TASK_FORMATTERS[name] = make_formatter(spec)


def expand_tasks(tasks: Sequence[str]) -> List[str]:
    """Suite expansion exactly as `evaluate.py:160-163`."""
    out: List[str] = []
    for t in tasks:
        if t == "mmlu":
            out += [f"hendrycksTest-{s}" for s in MMLU_SUBJECTS]
        elif t == "llmqat":
            out += LLMQAT_SUITE
        else:
            out.append(t)
    return out


def load_task_examples(task: str, split: str = "validation") -> List[Example]:
    """HF-datasets loading (needs the `datasets` package and a network or a
    populated cache; offline it raises as `datasets` does)."""
    try:
        from datasets import load_dataset
    except ImportError as e:
        raise ImportError(
            f"task {task!r}: loading examples needs the `datasets` package, which is not "
            "installed; pass examples_by_task= (hand-built Examples) instead") from e

    fmt = TASK_FORMATTERS[task]
    if task in TASK_SPECS:
        spec = TASK_SPECS[task]
        ds = load_dataset(spec.dataset, spec.subset, split=split if split != "validation" else spec.split)
        return [fmt(d) for d in ds]
    if task.startswith("hendrycksTest-"):
        ds = load_dataset("cais/mmlu", task[len("hendrycksTest-") :], split="test")
    elif task == "boolq":
        ds = load_dataset("super_glue", "boolq", split=split)
    elif task == "piqa":
        ds = load_dataset("piqa", split=split)
    elif task == "hellaswag":
        ds = load_dataset("hellaswag", split=split)
    elif task == "winogrande":
        ds = load_dataset("winogrande", "winogrande_xl", split=split)
    elif task in ("arc_easy", "arc_challenge"):
        ds = load_dataset("ai2_arc", "ARC-Easy" if task == "arc_easy" else "ARC-Challenge", split=split)
    elif task == "openbookqa":
        ds = load_dataset("openbookqa", "main", split=split)
    else:
        raise NotImplementedError(task)
    return [fmt(d) for d in ds]


def evaluate_model_tasks(
    params, cfg, fam, tokenizer,
    tasks: Sequence[str],
    limit: int = -1,
    examples_by_task: Optional[Dict[str, List[Example]]] = None,
    vocab_limit: Optional[int] = 50257,
    num_fewshot: int = 0,
    train_examples_by_task: Optional[Dict[str, List[Example]]] = None,
) -> Dict[str, Any]:
    """Mean-accuracy report like `evaluate.py:165-182`.

    ``vocab_limit`` defaults to 50257 — the reference slices EVERY model's
    logits to the first 50257 rows (`evaluate.py:79`, the OPT vocab hack; a
    no-op for vocabularies ≤ 50257 such as LLaMA's 32000). Pass None to
    disable.

    ``num_fewshot``: lm-eval v0.3 few-shot prompting (the reference inherits
    it via `evaluate.py:94,102`) — shots sampled from the task's train split
    (declarative specs / ``train_examples_by_task``) or, failing that, from
    the eval docs themselves minus the query (the v0.3 fallback)."""
    scorer = LoglikelihoodScorer(params, cfg, fam, tokenizer, vocab_limit=vocab_limit)
    results = {}
    for t in expand_tasks(tasks):
        examples = examples_by_task[t] if examples_by_task else load_task_examples(t)
        training = None
        desc = ""
        if train_examples_by_task and t in train_examples_by_task:
            training = train_examples_by_task[t]
        elif num_fewshot > 0 and not examples_by_task and t in TASK_SPECS \
                and TASK_SPECS[t].train_split:
            training = load_task_examples(t, split=TASK_SPECS[t].train_split)
        if t in TASK_SPECS:
            desc = TASK_SPECS[t].description
        results[t] = evaluate_task(scorer, examples, limit,
                                   num_fewshot=num_fewshot, training=training,
                                   description=desc)
    accs = [r["acc"] for r in results.values()]
    return {"results": results, "mean_acc": float(np.mean(accs)) if accs else float("nan")}
