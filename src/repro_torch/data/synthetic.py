"""Synthetic structured corpus (``repro.data.synthetic``, numpy only): the
CPU-scale stand-in for the paper's data.

The paper pretrains on a 600B-token English corpus and distills on
OIG-small-chip2 / OpenAssistant instructions. Offline the pipeline needs
*learnable structure* so that its effects are measurable: a low-entropy
bigram language over a small vocabulary with task-conditioned transition
matrices.

Tasks mirror the paper's evaluation suite:
  dolly  -- open-ended generation distribution (eval sampled, temp .6/top-p .9)
  cnndm  -- "news summarization" distribution (eval greedy)
  xsum   -- "extreme summarization" distribution (eval greedy)
  wmt    -- OOD distribution (paper A.5): a bigram matrix *not* mixed into
            pretraining or distillation, used for the OOD block-efficiency study.

Special tokens: 0 = PAD/EOS boundary, 1 = BOS, 2 = SEP (instruction/response).

A copy of the reference, draw for draw: the same corpus from the same seed.
Like the reference, ``chat_sft_docs`` and ``instructions`` seed their
generator with ``hash(task) % 1000``, and Python randomizes ``str`` hashes
per process unless ``PYTHONHASHSEED`` is set, so those two differ from one
process to the next (and agree with the reference's within one process).
The six (V - 3) x (V - 3) float64 transition matrices take 6 * 8 * V^2
bytes: 49 GB at V = 32000, so the corpus serves small vocabularies only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

PAD, BOS, SEP = 0, 1, 2
N_SPECIAL = 3

TASKS = ("dolly", "cnndm", "xsum")
OOD_TASKS = ("wmt",)


@dataclass
class SyntheticCorpus:
    vocab_size: int = 256
    seed: int = 0
    concentration: float = 0.25   # lower -> peakier bigrams -> more learnable

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._trans: Dict[str, np.ndarray] = {}
        V = self.vocab_size - N_SPECIAL
        for i, task in enumerate(TASKS + OOD_TASKS + ("pretrain", "chat")):
            alpha = np.full(V, self.concentration)
            t = rng.dirichlet(alpha, size=V).astype(np.float64)
            self._trans[task] = t
        self._rng = rng

    # ------------------------------------------------------------- sampling
    def _walk(self, rng, task: str, length: int) -> np.ndarray:
        t = self._trans[task]
        V = t.shape[0]
        out = np.empty(length, np.int32)
        cur = rng.integers(V)
        for i in range(length):
            cur = rng.choice(V, p=t[cur])
            out[i] = cur
        return out + N_SPECIAL

    def pretrain_docs(self, n: int, length: int, seed: int = 1) -> List[np.ndarray]:
        """Documents from a mixture of the in-distribution tasks + base."""
        rng = np.random.default_rng(seed)
        docs = []
        pool = list(TASKS) + ["pretrain"]
        for _ in range(n):
            task = pool[rng.integers(len(pool))]
            docs.append(self._walk(rng, task, int(rng.integers(length // 2, length))))
        return docs

    def chat_sft_docs(self, n: int, task: str, prompt_len: int = 12,
                      resp_len: int = 48, seed: int = 5):
        """Instruction(task-style) + SEP + response in the held-out "chat"
        style — the stand-in for chat fine-tuning the target (the paper's
        targets are chat-tuned; this creates the pretrain/chat distribution
        gap that draft alignment exists to close)."""
        rng = np.random.default_rng(seed + hash(task) % 1000)
        docs = []
        for _ in range(n):
            ins = self._walk(rng, task, prompt_len)
            resp = self._walk(rng, "chat", resp_len)
            docs.append(np.concatenate([[BOS], ins, [SEP], resp]).astype(np.int32))
        return docs

    def instructions(self, n: int, length: int, task: str, seed: int = 2) -> np.ndarray:
        """Seed instructions: (n, length+2) with BOS ... SEP framing."""
        rng = np.random.default_rng(seed + hash(task) % 1000)
        out = np.zeros((n, length + 2), np.int32)
        out[:, 0] = BOS
        for i in range(n):
            out[i, 1:length + 1] = self._walk(rng, task, length)
        out[:, length + 1] = SEP
        return out
